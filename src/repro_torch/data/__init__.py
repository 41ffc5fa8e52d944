"""Data layer of the port: the learned dispatch fallback (decision tree)."""
from repro_torch.data.dtree import (
    ALPHA_CAP, FEATURES, DecisionTree, DispatchTreeStore,
    features_from_report)

__all__ = ["ALPHA_CAP", "FEATURES", "DecisionTree", "DispatchTreeStore",
           "features_from_report"]
