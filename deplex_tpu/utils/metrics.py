"""Label agreement metric shared by the tests, the conformance report and
chip_smoke.py."""

from __future__ import annotations

import numpy as np


def label_f1(pred: np.ndarray, gold: np.ndarray):
    """Plane-label F1 with greedy per-gold-plane matching: gold planes in
    order of size each take the largest not-yet-used predicted plane inside
    them. Returns (f1, precision, recall)."""
    pred = np.asarray(pred).reshape(-1)
    gold = np.asarray(gold).reshape(-1)
    gold_ids, gold_counts = np.unique(gold[gold > 0], return_counts=True)
    order = np.argsort(-gold_counts)
    used = set()
    tp = 0
    for g in gold_ids[order]:
        overl = pred[(gold == g) & (pred > 0)]
        if overl.size == 0:
            continue
        ids, cnts = np.unique(overl, return_counts=True)
        for i in np.argsort(-cnts):
            if ids[i] not in used:
                used.add(ids[i])
                tp += int(cnts[i])
                break
    n_pred = int((pred > 0).sum())
    n_gold = int((gold > 0).sum())
    precision = tp / max(n_pred, 1)
    recall = tp / max(n_gold, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return f1, precision, recall
