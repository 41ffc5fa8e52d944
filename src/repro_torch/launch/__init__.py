"""Launchers of the port: the streamed-SpMM server."""
