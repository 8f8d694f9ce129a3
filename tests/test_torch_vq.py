"""The vq_argmin kernel's algorithm emulated on the CPU, and the codebook's
search.

The kernel (csrc/vq_argmin.cu) sums each staged code's squared norm, then
computes d = ||e_k||^2 + sum_j (-2 x_j) e_kj, keeps a chunk minimum over
each 4 codes of its slice, takes the first chunk whose minimum beats the
running best by strict `<`, rescans that chunk for the first code at the
best distance, and merges the code slices by the lexicographic minimum of
(order-preserving distance bits, index), with -0 taken as +0. Here that
search runs in numpy on distance matrices with exact ties planted across
chunk and slice boundaries, against torch.argmin (first index of the
minimum); and a code dim zero-padded as the kernel pads it gives the same
norms and distances bit for bit."""

import numpy as np
import pytest
import torch

from omnitokenizer_tpu_torch.ops.codebook import Codebook
from omnitokenizer_tpu_torch.ops.kernels.vq_argmin import vq_argmin, vq_argmin_plain

torch.set_num_threads(1)

CHUNK = 4             # codes a chunk (csrc/vq_argmin.cu kChunk)
INSTANCES = (4, 8, 16, 32)  # code dims of the kernel's instances


def kernel_distances(flat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """(M, K) distances in the kernel's order of terms: ||e_k||^2 summed over
    j ascending, then (-2 x_j) e_kj for j ascending, each step rounded to
    f32."""
    esq = torch.zeros(emb.shape[0])
    for j in range(emb.shape[1]):
        esq = esq + emb[:, j] * emb[:, j]
    xs = -2.0 * flat
    d = esq[None, :].expand(flat.shape[0], -1).clone()
    for j in range(flat.shape[1]):
        d = d + xs[:, j:j + 1] * emb[None, :, j]
    return d


def order_bits(d: np.ndarray) -> np.ndarray:
    """f32 -> uint64 whose unsigned order is the float order, -0 as +0."""
    u = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def kernel_search(dist: np.ndarray, ks: int) -> np.ndarray:
    """The kernel's argmin over a distance matrix with code slices of ks."""
    M, K = dist.shape
    keys = np.full(M, np.iinfo(np.uint64).max, np.uint64)
    rows = np.arange(M)
    for k0 in range(0, K, ks):
        sl = dist[:, k0:k0 + ks]
        n = sl.shape[1]
        pad = -n % CHUNK  # padding codes: +inf, never the best
        chunks = np.pad(sl, ((0, 0), (0, pad)), constant_values=np.inf).reshape(M, -1, CHUNK)
        mins = chunks.min(-1)
        best = np.full(M, np.inf, np.float32)
        won = np.zeros(M, np.int64)
        for c in range(mins.shape[1]):  # strict <: the first chunk at the minimum
            better = mins[:, c] < best
            best, won = np.where(better, mins[:, c], best), np.where(better, c, won)
        first = np.argmax(chunks[rows, won] == best[:, None], axis=1)  # the rescan
        idx = k0 + np.minimum(won * CHUNK + first, n - 1)
        keys = np.minimum(keys, order_bits(best) << np.uint64(32) | idx.astype(np.uint64))
    return (keys & 0xFFFFFFFF).astype(np.int32)


@pytest.mark.parametrize("K,ks", [(1, 16), (100, 16), (1000, 48), (8192, 432), (8193, 432),
                                  (8192, 8192)])
def test_kernel_search_takes_the_first_index(K, ks):
    rng = np.random.RandomState(K + ks)
    M = 64
    dist = rng.randn(M, K).astype(np.float32)  # negative distances too
    low = dist.min() - 1
    # exact ties: across chunk boundaries, a slice boundary, the two ends,
    # three ways, inside one chunk, and with the minimum in a later slice
    for m, where in enumerate([(15, 16), (ks - 1, ks), (0, K - 1), (3, 17, ks + 5),
                               (ks + 1, 2 * ks + 2), (3, 4), (47, 48, 49), (9, 10)]):
        for k in where:
            if k < K:
                dist[m, k] = low - m
    dist[40, :] = 2.5  # every code at one distance
    want = torch.argmin(torch.from_numpy(dist), dim=1).numpy()
    np.testing.assert_array_equal(kernel_search(dist, ks), want)


@pytest.mark.parametrize("first", [-0.0, 0.0])
@pytest.mark.parametrize("K,ks", [(1000, 48), (8193, 432), (8192, 8192)])
def test_kernel_search_zero_distance_ties(K, ks, first):
    """An exact zero distance, +0 or -0, on both sides of a slice boundary
    and in two slices: the lowest index wins whatever the signs."""
    rng = np.random.RandomState(K)
    M = 8
    dist = np.abs(rng.randn(M, K)).astype(np.float32) + 0.5  # all above zero
    for m, where in enumerate([(ks - 1, ks), (5, ks + 5), (ks - 2, 2 * ks + 1), (0, K - 1)]):
        where = [k for k in where if k < K]
        dist[m, where[0]] = first
        for k in where[1:]:
            dist[m, k] = -first  # the other sign after the first
    want = torch.argmin(torch.from_numpy(dist), dim=1).numpy()
    np.testing.assert_array_equal(kernel_search(dist, ks), want)


@pytest.mark.parametrize("D", [1, 3, 6, 12, 20])
def test_zero_padded_code_dim_is_exact(D):
    """A code dim padded with zeros to the next instance, as the kernel pads
    x and the codes, gives the unpadded norms and distances bit for bit."""
    rng = np.random.RandomState(D)
    flat = torch.from_numpy(rng.randn(200, D).astype(np.float32))
    emb = torch.from_numpy(rng.randn(300, D).astype(np.float32))
    width = next(w for w in INSTANCES if w >= D)
    pad = torch.nn.functional.pad
    d = kernel_distances(flat, emb)
    d_pad = kernel_distances(pad(flat, (0, width - D)), pad(emb, (0, width - D)))
    assert torch.equal(d_pad, d)
    got = kernel_search(d_pad.numpy(), 48)
    np.testing.assert_array_equal(got, kernel_search(d.numpy(), 48))
    # against the plain version: indices differ only at near-ties
    plain = vq_argmin_plain(flat, emb).numpy()
    bad = np.nonzero(got != plain)[0]
    exact = ((flat[:, None, :].double() - emb[None].double()) ** 2).sum(-1).numpy()
    gap = np.abs(exact[bad, got[bad]] - exact[bad, plain[bad]]) / exact[bad, plain[bad]]
    assert bad.size == 0 or gap.max() <= 1e-5


def test_codebook_search_follows_the_embeddings():
    """The codebook's indices are the nearest codes of its current
    embeddings after load_state_dict (in place and assigned) and after an
    in-place write."""
    torch.manual_seed(0)
    cb = Codebook(64, 6)
    cb.embeddings.copy_(torch.randn(64, 6))
    z = torch.randn(2, 3, 4, 4, 6)
    flat = z.reshape(-1, 6)

    def check():
        out = cb(z)
        assert torch.equal(out["encodings"].flatten(), vq_argmin_plain(flat, cb.embeddings))
        # the straight-through z + (q - z) rounds once or twice
        torch.testing.assert_close(out["embeddings"].reshape(-1, 6),
                                   cb.embeddings[out["encodings"].flatten().long()],
                                   rtol=0, atol=1e-6)

    check()
    cb.load_state_dict({**cb.state_dict(), "embeddings": torch.randn(64, 6)})
    check()
    with torch.no_grad():
        cb.embeddings.mul_(-2)  # in place
    check()
    cb.load_state_dict({**cb.state_dict(), "embeddings": torch.randn(64, 6)}, assign=True)
    check()
    with torch.inference_mode():
        assert torch.equal(cb(z)["encodings"].flatten(), vq_argmin(flat, cb.embeddings))
