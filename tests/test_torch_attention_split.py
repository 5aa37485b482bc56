"""The decode kernel's split over the cache, on the CPU: the wrapper's
choice of split (`decode_splits`) and its ranges (`split_ranges`, whose
bounds the kernel is given), and a plain model of the kernel's
split-and-merge — each range's online-softmax state (m, l, acc), merged
in rank order as the cluster's rank 0 merges them — held against the
port's `decode_attention_ref`, the reference's `decode_attention_ref`
and the Pallas `decode_attention` in interpret mode, at the shapes of
tests/test_torch_attention.py.  Tolerances: f32 2e-5 (summation order),
as there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import shared_cores  # noqa: E402,F401 (autouse)

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref

from repro_torch.kernels.decode_attention import kernel as DK
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)


def split_merge(q, k, v, valid_len, n_split):
    """The kernel's arithmetic in plain PyTorch: per rank, the range's
    running max m, denominator l and unnormalised accumulator acc (f32);
    then, in rank order, the max over ranks and the sums rescaled to it.
    An empty range has m = -inf and adds nothing."""
    B, H, hd = q.shape
    K = k.shape[1]
    qf = q.reshape(B, K, H // K, hd).float() / hd ** 0.5
    parts = []
    for lo, hi in DK.split_ranges(valid_len, n_split):
        s = torch.einsum("bkgh,bkth->bkgt", qf, k[:, :, lo:hi].float())
        m = s.amax(-1) if hi > lo else torch.full(s.shape[:-1],
                                                  float("-inf"))
        p = torch.exp(s - m[..., None]) if hi > lo else s
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgt,bkth->bkgh", p,
                                   v[:, :, lo:hi].float())))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    den = torch.zeros_like(mx)
    num = torch.zeros(B, K, H // K, hd)
    for m, l, acc in parts:
        c = torch.where(m == float("-inf"), 0.0, torch.exp(m - mx))
        den = den + l * c
        num = num + acc * c[..., None]
    return (num / den.clamp_min(1e-30)[..., None]).reshape(B, H, hd).to(
        q.dtype)


@pytest.mark.parametrize("valid_len", [1, 7, 127, 128, 255, 256, 257, 600,
                                       1023, 1024, 1088, 100_000])
@pytest.mark.parametrize("blocks", [1, 64, 128, 264, 1024])
def test_split_ranges_cover_valid_len_once(valid_len, blocks):
    n = DK.decode_splits(valid_len, blocks)
    assert n in DK.SPLITS
    ranges = DK.split_ranges(valid_len, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == valid_len
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)          # none is empty
    if n > 1:                                          # ranges stay long
        assert min(hi - lo for lo, hi in ranges) >= DK.SPLIT_MIN_ROWS
        assert blocks * n // 2 < DK.SPLIT_TARGET_BLOCKS  # the least split
    if valid_len < 2 * DK.SPLIT_MIN_ROWS or blocks >= DK.SPLIT_TARGET_BLOCKS:
        assert n == 1


def test_decode_splits_at_the_serve_shapes():
    """Qwen (K 16, G 1) and Jamba (K 8, G 8), bf16, one group of query
    rows per kv-head: no split at the serve batch (B 8: 128 and 64
    blocks, 1,025-1,088 slots), 8 ranges for one sequence of 8,193-8,256
    slots (the long-context run), none for one of 1,088."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert DK.query_groups(1, bf16) == DK.query_groups(8, bf16) == (16, 1)
    assert DK.query_groups(48, bf16) == (16, 3)
    assert DK.query_groups(1, f32) == (1, 1) and DK.query_groups(8, f32) \
        == (8, 1)
    assert DK.query_groups(48, f32) == (8, 6)
    assert DK.query_groups(3, f32) == (4, 1)
    for T in (1025, 1088):              # B 8: 128 and 64 blocks
        assert DK.decode_splits(T, 8 * 16) == DK.decode_splits(T, 8 * 8) == 1
    assert DK.decode_splits(1088, 16) == DK.decode_splits(1088, 8) == 1
    for T in (8193, 8256):              # B 1: 16 and 8 blocks
        assert DK.decode_splits(T, 16) == DK.decode_splits(T, 8) == 8
    assert DK.decode_splits(8192, 8 * 16) == 1
    assert DK.split_ranges(1088, 4) == [(0, 272), (272, 544), (544, 816),
                                        (816, 1088)]
    assert DK.split_ranges(7, 3) == [(0, 2), (2, 4), (4, 7)]
    assert DK.decode_splits(1, 8 * 16) == 1


def test_run_decode_on_the_cpu_is_the_plain_version():
    """Off the card the wrapper with a split given returns the plain
    version too (the split is the kernel's business)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 300, 64)).astype(
        np.float32)) for _ in range(2))
    want = decode_attention_ref(q, k, v, 250)
    for n in (None, *DK.SPLITS):
        assert torch.equal(DK.run_decode(q, k, v, 250, n), want)
    assert torch.equal(DK.decode_attention(q, k, v, 250), want)


@pytest.mark.parametrize("B,H,K,T,hd", [(2, 8, 2, 512, 64),
                                        (1, 4, 4, 256, 128),
                                        (4, 4, 1, 1024, 64),
                                        (2, 8, 4, 256, 32)])
@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_split_merge_matches_refs(B, H, K, T, hd, n_split):
    rng = np.random.default_rng(T + n_split)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, K, T, hd)).astype(np.float32)
            for _ in range(2))
    for vl in (1, n_split + 1, T // 2, T):
        got = split_merge(*(torch.from_numpy(x) for x in (q, k, v)), vl,
                          n_split).numpy()
        want = decode_attention_ref(*(torch.from_numpy(x)
                                      for x in (q, k, v)), vl).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            got, np.asarray(jax_decode_ref(q, k, v, vl)), **TOL)
        if vl == T // 2:
            pal = pallas_decode(q, k, v, vl, block_t=128, interpret=True)
            np.testing.assert_allclose(got, np.asarray(pal), **TOL)
