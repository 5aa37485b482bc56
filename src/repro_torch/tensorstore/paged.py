"""Page-range helper of the paged store layout.

Layout (shared with `mirror.PagedMirror.torch_store_for`):
  data [P, K, page_elems]   — K version slots per page
  ts   [P, K] int32         — commit timestamp per slot (0 = initial)

Only `as_page_range` is on the port's main path so far; the store
builders and gather ops of the reference's `tensorstore/paged.py` come
with the gather kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def as_page_range(pages) -> Optional[tuple[int, int]]:
    """Dense key-range -> page-range resolution: when a page-index array is
    a contiguous ascending run, return its (start, stop) so multi-page
    scans can slice the store instead of gathering (the columnar fast
    path); None otherwise (holes, missing keys, or arbitrary order)."""
    arr = np.asarray(pages)
    if arr.size == 0 or arr[0] < 0:
        return None
    start = int(arr[0])
    if np.array_equal(arr, np.arange(start, start + arr.size)):
        return start, start + int(arr.size)
    return None
