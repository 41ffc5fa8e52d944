"""Data layer of the port: the matrix corpus and the learned dispatch
fallback (decision tree).

``corpus`` loads real-matrix files (``.smtx`` / Matrix Market) with a
vendored offline sample set; ``dtree`` is the decision-tree dispatch
fallback that ``repro_torch.launch.harvest_dispatch`` fits.
"""
from repro_torch.data.corpus import (
    CorpusDownloadDisabled, CorpusEntry, corpus_entries, load_corpus,
    load_matrix, load_mtx, load_smtx, vendored_entries, write_mtx,
    write_smtx)
from repro_torch.data.dtree import (
    ALPHA_CAP, FEATURES, DecisionTree, DispatchTreeStore,
    features_from_report)

__all__ = ["CorpusDownloadDisabled", "CorpusEntry", "corpus_entries",
           "load_corpus", "load_matrix", "load_mtx", "load_smtx",
           "vendored_entries", "write_mtx", "write_smtx",
           "ALPHA_CAP", "FEATURES", "DecisionTree", "DispatchTreeStore",
           "features_from_report"]
