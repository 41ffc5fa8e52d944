"""``pack_s``: seconds inside ``Dispatcher.prepare`` (convert, pack, copy the
layout to the card), timed by the benchmark around the call."""


def read(rec):
    """The prepare call's time, or None if the program never packed."""
    return rec.pack_s
