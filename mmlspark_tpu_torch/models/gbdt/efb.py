"""Exclusive-feature bundling for wide sparse inputs (EFB-lite): the port's
own copy of ``mmlspark_tpu/models/gbdt/efb.py`` (numpy only, the same plan
bit for bit).

Native LightGBM handles 2^18-dim hashed-text features by bundling mutually
exclusive sparse columns (columns that are almost never nonzero on the same
row) into single dense features — its EFB optimization — so the histogram
build touches bundles, not raw columns. Round 1 instead truncated to the
top-k document-frequency columns, losing every rarer column.

The formulation maps bundles onto machinery that already exists:

  * a bundle's composite code is ``0`` (no member nonzero) or ``p`` (member
    at position p-1 is nonzero) — i.e. a CATEGORY ID;
  * bundle columns are therefore declared ``categorical_feature``s: the
    engine identity-bins them and the leaf-wise grower finds CATEGORY-SET
    splits over them — "rows containing any of {token17, token203, ...}
    go right", exactly the split shape hashed text wants;
  * membership caps at max_bin-1 per bundle (uint8 bins), packing greedily
    by density with a sampled-bitmap conflict test (LightGBM samples rows
    for the same reason: exact pairwise conflict counting over 2^18
    columns is quadratic).

The top-k densest columns keep their full numeric values (the round-1
behavior); only the TAIL beyond ``maxDenseFeatures`` is bundled — strictly
more information than truncation, never less.
"""

from __future__ import annotations

import numpy as np

from ...core.utils import get_logger

log = get_logger("gbdt.efb")

#: sampled rows for the conflict bitmaps
_SAMPLE = 8192
#: max sampled-row conflicts tolerated when adding a column to a bundle
_CONFLICT_BUDGET = 4
#: tail columns considered for bundling (beyond this, rarest columns drop —
#: with a warning — instead of exploding plan time)
_BUNDLE_CAP = 1 << 17


def plan_bundles(csc, cols: np.ndarray, max_bin: int,
                 seed: int = 0) -> list[np.ndarray]:
    """Greedy first-fit packing of ``cols`` (ids into csc) into bundles of
    ≤ max_bin-1 members with ≤ _CONFLICT_BUDGET sampled-row conflicts.
    Returns a list of column-id arrays (member position = category id - 1).
    """
    n = csc.shape[0]
    if len(cols) > _BUNDLE_CAP:
        log.warning("bundling the %d densest tail columns of %d (rest "
                    "dropped; raise maxDenseFeatures to keep more as "
                    "dense)", _BUNDLE_CAP, len(cols))
        cols = cols[:_BUNDLE_CAP]
    rng = np.random.default_rng(seed)
    sample = (np.arange(n) if n <= _SAMPLE
              else np.sort(rng.choice(n, _SAMPLE, replace=False)))
    # (col, sample-bitmap) packed to uint8 for cheap AND/OR conflict tests
    occupancy: list[np.ndarray] = []   # per-bundle OR of member bitmaps
    bundles: list[list[int]] = []
    cap = max_bin - 1
    sub = csc[sample]
    # poorly-exclusive tails would otherwise make first-fit quadratic
    # (every column ANDing against every bundle); LightGBM bounds the
    # search the same way (max_conflict search limit)
    max_probes = 64
    for j in cols:
        colvec = np.zeros(len(sample), dtype=bool)
        colvec[sub.indices[sub.indptr[j]:sub.indptr[j + 1]]] = True
        bits = np.packbits(colvec)
        placed = False
        probes = 0
        for b, occ in enumerate(occupancy):
            if len(bundles[b]) >= cap:
                continue
            probes += 1
            if probes > max_probes:
                break
            conflicts = int(np.bitwise_count(occ & bits).sum()) \
                if hasattr(np, "bitwise_count") else \
                int(np.unpackbits(occ & bits).sum())
            if conflicts <= _CONFLICT_BUDGET:
                bundles[b].append(int(j))
                occupancy[b] = occ | bits
                placed = True
                break
        if not placed:
            bundles.append([int(j)])
            occupancy.append(bits)
    return [np.asarray(b, dtype=np.int64) for b in bundles]


def apply_bundles(csc, bundles: list[np.ndarray]) -> np.ndarray:
    """CSC matrix -> (n, n_bundles) float32 composite category codes.

    Code 0 = no member nonzero; code p = member at position p-1 is nonzero
    (on a within-budget conflict, the DENSER member wins — members are
    ordered by density, so later writes are rarer columns; we write in
    reverse so the densest lands last)."""
    n = csc.shape[0]
    out = np.zeros((n, len(bundles)), dtype=np.float32)
    for b, members in enumerate(bundles):
        for p in range(len(members) - 1, -1, -1):
            j = int(members[p])
            rows = csc.indices[csc.indptr[j]:csc.indptr[j + 1]]
            out[rows, b] = p + 1
    return out


def plan_and_split(mat_csc, cap: int, max_bin: int, seed: int = 0,
                   doc_freq=None):
    """The stage-side entry: given a wide sparse CSC matrix, return
    (dense_col_ids, bundles) — the ``cap`` densest columns stay numeric
    (round-1 behavior), the tail bundles into categorical composites.
    ``doc_freq`` overrides the local counts."""
    if doc_freq is None:
        doc_freq = np.diff(mat_csc.indptr)
    order = np.argsort(-doc_freq, kind="stable")
    dense = np.sort(order[:cap]).astype(np.int64)
    tail = order[cap:]
    tail = tail[doc_freq[tail] > 0]        # empty columns carry nothing
    bundles = plan_bundles(mat_csc, tail, max_bin, seed) if len(tail) else []
    return dense, bundles
