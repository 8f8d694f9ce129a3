"""The vq_argmin kernel's algorithm emulated on the CPU, and the codebook's
search.

The kernel (csrc/vq_argmin.cu) computes d = ||e_k||^2 + sum_j (-2 x_j) e_kj,
with ||e_k||^2 summed over j ascending, and merges its code slices by the
lexicographic minimum of (order-preserving distance bits, index), with -0
taken as +0. Within a slice its two paths search differently. At code dims
<= 32 it keeps a chunk minimum over each 4 codes of its slice, takes the
first chunk whose minimum beats the running best by strict `<`, and rescans
that chunk for the first code at the best distance. Above 32, in tiles of
256 codes, each of the 16 threads that share a row keeps a strict-`<`
running minimum over its codes (64 q + 4 tx + j of each tile, q, j < 4,
ascending), and the 16 threads merge by the same lexicographic minimum. Here those searches run
in numpy on distance matrices with exact ties planted across chunk, thread,
tile and slice boundaries, against torch.argmin (first index of the
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
TILE = 256            # codes a tile of the wide path (kTileCodes)
LANES = 16            # threads that share a row of the wide path
GROUPS = 4            # groups of 4 codes a thread holds, 64 codes apart (kCodeGroups)
BK = 16               # code dims a step of the wide path, D zero-padded to a multiple (kBK)


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


def tiled_search(dist: np.ndarray, ks: int) -> np.ndarray:
    """The wide path's argmin (code dims > 32) over a distance matrix with
    code slices of ks (a multiple of TILE): thread tx of a row runs a
    strict-< minimum over codes 64 q + 4 tx + j of each tile of its slice,
    ascending, from (+inf, the slice's first code); the 16 threads' keys
    merge by their minimum, and the slices' by atomicMin."""
    assert ks % TILE == 0
    M, K = dist.shape
    keys = np.full(M, np.iinfo(np.uint64).max, np.uint64)
    for k0 in range(0, K, ks):
        sl = dist[:, k0:k0 + ks]
        tiles = -(-sl.shape[1] // TILE)
        # padding codes: their chains start at +inf, never the best
        sl = np.pad(sl, ((0, 0), (0, tiles * TILE - sl.shape[1])), constant_values=np.inf)
        # [m, tile, q, tx, j] -> each thread's codes in its order: [m, tx, (tile, q, j)]
        shape = (tiles, GROUPS, LANES, TILE // GROUPS // LANES)
        seq = sl.reshape(M, *shape).transpose(0, 3, 1, 2, 4).reshape(M, LANES, -1)
        codes = np.arange(tiles * TILE).reshape(shape).transpose(2, 0, 1, 3).reshape(LANES, -1)
        best = np.full((M, LANES), np.inf, np.float32)
        idx = np.zeros((M, LANES), np.int64)
        for i in range(seq.shape[2]):
            better = seq[:, :, i] < best
            best = np.where(better, seq[:, :, i], best)
            idx = np.where(better, codes[None, :, i], idx)
        lane_keys = order_bits(best) << np.uint64(32) | (k0 + idx).astype(np.uint64)
        keys = np.minimum(keys, lane_keys.min(axis=1))
    return (keys & 0xFFFFFFFF).astype(np.int32)


def plant_ties(dist: np.ndarray, ks: int) -> None:
    """Exact ties below every other distance, one set a row: across thread
    boundaries (codes 3 and 4, 63 and 64), inside one thread (j and j + 1,
    q and q + 1), across a tile boundary, a slice boundary, the two ends,
    three ways, and with the minimum first reached in a later slice."""
    K = dist.shape[1]
    low = dist.min() - 1
    for m, where in enumerate([(3, 4), (63, 64), (1, 2), (5, 69), (255, 256), (ks - 1, ks),
                               (0, K - 1), (5, 260, ks + 7), (ks + 1, 2 * ks + 2),
                               (31, 32, 33), (TILE - 16, TILE + LANES - 1)]):
        for k in where:
            if k < K:
                dist[m, k] = low - m


@pytest.mark.parametrize("M,K,ks", [(64, 1, 256), (64, 100, 256), (64, 2048 + 5, 256),
                                    (64, 2048 + 5, 1024), (64, 2048 + 5, 2304),
                                    (64, 8193, 4352), (16384 + 33, 2048 + 5, 1024)])
def test_tiled_search_takes_the_first_index(M, K, ks):
    rng = np.random.RandomState(K + ks)
    dist = rng.randn(M, K).astype(np.float32)  # negative distances too
    plant_ties(dist, ks)
    dist[40, :] = 2.5  # every code at one distance
    dist[41, :] = np.inf  # every code at +inf: the first
    want = torch.argmin(torch.from_numpy(dist), dim=1).numpy()
    np.testing.assert_array_equal(tiled_search(dist, ks), want)


@pytest.mark.parametrize("first", [-0.0, 0.0])
@pytest.mark.parametrize("K,ks", [(1000, 256), (2048 + 5, 1024), (8193, 4352)])
def test_tiled_search_zero_distance_ties(K, ks, first):
    """An exact zero distance, +0 or -0, in one thread, in two threads of a
    tile, across a tile boundary, a slice boundary and two slices: the
    lowest index wins whatever the signs."""
    rng = np.random.RandomState(K)
    M = 8
    dist = np.abs(rng.randn(M, K)).astype(np.float32) + 0.5  # all above zero
    for m, where in enumerate([(1, 2), (3, 67), (3, 4), (TILE - 1, TILE), (ks - 1, ks),
                               (5, ks + 5), (ks - 2, 2 * ks + 1), (0, K - 1)]):
        where = [k for k in where if k < K]
        dist[m, where[0]] = first
        for k in where[1:]:
            dist[m, k] = -first  # the other sign after the first
    want = torch.argmin(torch.from_numpy(dist), dim=1).numpy()
    np.testing.assert_array_equal(tiled_search(dist, ks), want)


@pytest.mark.parametrize("D", [33, 37, 64, 100, 256])
def test_tiled_search_on_wide_code_dims(D):
    """Rows against 2048 + 5 codes at a wide code dim: the tiled search over
    the kernel's distances, padded to a multiple of BK as the kernel pads
    them, is torch.argmin of the unpadded distances, bit for bit; with
    duplicate codes (a period of 97) the first occurrence wins."""
    rng = np.random.RandomState(D)
    M, K = 1000 + 33, 2048 + 5
    flat = rng.randn(M, D).astype(np.float32)
    flat /= np.linalg.norm(flat, axis=1, keepdims=True)
    emb = rng.randn(97, D).astype(np.float32)[np.arange(K) % 97]
    flat, emb = torch.from_numpy(flat), torch.from_numpy(emb)
    pad = torch.nn.functional.pad
    width = -(-D // BK) * BK
    d = kernel_distances(flat, emb)
    d_pad = kernel_distances(pad(flat, (0, width - D)), pad(emb, (0, width - D)))
    assert torch.equal(d_pad, d)
    want = torch.argmin(d, dim=1).numpy()
    assert bool((want < 97).all())
    for ks in (1024, 2304):
        np.testing.assert_array_equal(tiled_search(d_pad.numpy(), ks), want)


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
