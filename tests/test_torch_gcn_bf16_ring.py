"""The bfloat16 GCN forward's slice kernel (K2 bf16, N <= 192), modelled on the CPU.

``paddlexde_tpu_torch/ops/csrc/gcn_bf16.cu`` (``slice_items``) runs a
persistent grid of ``min(slices, SMs x CTAs per SM)`` CTAs. CTA ``c`` takes
the (b, t) slices ``c, c + grid, ...``; its warpgroup ``w`` takes row tile
``w`` (rows 64 w .. 64 w + 63) of each. The slice's node tiles stay in
shared memory for the whole item:

- every thread copies its share of the slice's tiles in (cp.async) and makes
  its arrival on the one mbarrier ``full`` when its copies land; the k-th
  slice of a CTA waits for the phase of parity k & 1;
- for each node tile the CUDA cores build the B of the scores from the
  resident copy, a CTA barrier, the scores (A: the warpgroup's own resident
  tile), a CTA barrier;
- after the softmax the B of the mix of every node tile is built from the
  resident copies and a CTA barrier follows: no thread reads the resident
  tiles again, and the next slice's copies are issued there, under this
  slice's mix;
- the mix reads the B tiles built in this slice; a CTA barrier ends the item.

This file walks those schedules in numpy with random interleavings of the
warpgroups and the copy engine, and checks that every (row tile, slice) is
taken once, that every read of a resident or built tile sees the slice it
belongs to (no stage refilled before both products are done with it), and
that the mix's B, as a wgmma descriptor reads it, is the transposed node
tile. Controls: a walk with the wrong stride, a wait on the wrong parity,
a refill issued before the barrier that follows the mix's B, and a mix B
read at the wrong pass offset must each be caught.
"""

import numpy as np

NT, KS, MIX_N = 64, 16, 32


def walk(slices, tiles, sms, per_sm, stride=None):
    """{(row tile, slice): times taken} of the persistent walk."""
    grid = min(slices, sms * per_sm)
    taken = {}
    for c in range(grid):
        for s in range(c, slices, stride or grid):
            for w in range(tiles):
                taken[(w, s)] = taken.get((w, s), 0) + 1
    return taken


def test_slice_walk_takes_every_row_tile_once():
    # fewer slices than SMs, PEMS08's 384 at 1 CTA a SM, SYNTH's at 3, a
    # ragged tail, a card with few SMs
    for slices, tiles, per_sm in ((6, 3, 1), (384, 3, 1), (384, 1, 3), (384, 2, 1), (1000, 3, 1),
                                  (131, 2, 1), (133, 3, 1), (1, 1, 3)):
        for sms in (132, 8):
            taken = walk(slices, tiles, sms, per_sm)
            assert taken == {(w, s): 1 for w in range(tiles) for s in range(slices)}
            # shared out evenly: a CTA's count of slices differs by at most one
            grid = min(slices, sms * per_sm)
            counts = [len(range(c, slices, grid)) for c in range(grid)]
            assert max(counts) - min(counts) <= 1
    # control: stepping by the SM count where 3 CTAs share an SM takes
    # slices three times
    assert walk(384, 1, 132, 3, stride=132) != {(0, s): 1 for s in range(384)}


class Barrier:
    """An mbarrier: ``count`` arrivals complete a phase; ``passed(parity)``
    is ``mbarrier.try_wait.parity``."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


def run(actors, rng):
    """Step runnable actors (generators yielding a wait predicate or None)
    in random order until all finish; False on a deadlock."""
    waits = {i: None for i in range(len(actors))}
    live = set(waits)
    while live:
        ready = [i for i in live if waits[i] is None or waits[i]()]
        if not ready:
            return False
        i = ready[rng.integers(len(ready))]
        try:
            waits[i] = next(actors[i])
        except StopIteration:
            live.discard(i)
    return True


def slice_cta(items, tiles, rng, parity_shift=0, early_refill=False):
    """One CTA's slices ``0 .. items - 1``: ``tiles`` warpgroups, each
    copying its share of every resident tile (raw[t][w] holds the slice
    its copy brought, None while in flight), and the copy engine landing
    the copies in any order. Returns (no deadlock, every read saw its
    slice)."""
    raw = [[None] * tiles for _ in range(tiles)]
    built = [None] * tiles  # the mix's B tiles: the slice they were built in
    full = Barrier(tiles)
    sync = {"arrived": 0, "gen": 0}
    copies, ok = [], [True]

    def cta_barrier():
        gen = sync["gen"]
        sync["arrived"] += 1
        if sync["arrived"] == tiles:
            sync["arrived"], sync["gen"] = 0, gen + 1
        yield lambda: sync["gen"] != gen

    def fill(s, w):
        for t in range(tiles):
            raw[t][w] = None
        copies.append((s, w))

    def engine():
        for _ in range(items):
            for _ in range(tiles):
                yield lambda: bool(copies)
                s, w = copies.pop(rng.integers(len(copies)))
                for t in range(tiles):
                    raw[t][w] = s
                full.arrive()  # the warpgroup's copies have landed

    def reads(t, s):
        ok[0] &= raw[t] == [s] * tiles

    def warpgroup(w):
        fill(0, w)
        for k in range(items):
            yield lambda k=k: full.passed((k + parity_shift) & 1)
            for t in range(tiles):
                reads(t, k)  # the scores' B, built from resident tile t
                yield None
                yield from cta_barrier()
                reads(w, k)  # the scores' A: the warpgroup's own tile
                yield None
                yield from cta_barrier()
            for t in range(tiles):
                reads(t, k)  # the mix's B, built from resident tile t
                built[t] = k
                yield None
            if early_refill and k + 1 < items:
                fill(k + 1, w)
            yield from cta_barrier()
            if not early_refill and k + 1 < items:
                fill(k + 1, w)
            for t in range(tiles):  # the mix
                ok[0] &= built[t] == k
                yield None
            yield from cta_barrier()

    done = run([warpgroup(w) for w in range(tiles)] + [engine()], rng)
    return done, ok[0]


def test_tile_ring_hands_over_by_phase():
    rng = np.random.default_rng(0)
    for tiles in (1, 2, 3):
        for items in (1, 2, 3, 5):
            for _ in range(15):
                assert slice_cta(items, tiles, rng) == (True, True)
    # controls: a wait on the other parity reads tiles not yet in (or
    # hangs); a refill before the barrier after the mix's B overwrites a
    # tile another warpgroup still reads
    assert any(slice_cta(3, 3, rng, parity_shift=1) != (True, True) for _ in range(15))
    assert any(slice_cta(3, 3, rng, early_refill=True) != (True, True) for _ in range(30))


def b_offset(n, k):
    """tc_bf16.cuh's b_offset: K-major core matrices of 8 n x 8 k."""
    return (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8


def read_b_tile(buf, start, n_out):
    """The [16 k x n_out n] bfloat16 B tile a wgmma descriptor (no swizzle,
    leading byte offset 128, stride 256) at element ``start`` reads."""
    n = np.arange(n_out)[None, :]
    k = np.arange(KS)[:, None]
    return buf[start + (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8]


def mix_from(tile, d):
    """gcn_bf16.cu's mix_from: a resident node tile [NT, d] -> the mix's B,
    [NT / 16][d * 16], thread u writing feature u % d of nodes 8 (u // d) ..
    + 7."""
    dst = np.full((NT // 16, d * 16), np.nan)
    for u in range((NT // 8) * d):
        f, c = u % d, u // d
        off = b_offset(f, (8 * c) % 16)
        dst[c // 2, off:off + 8] = tile[8 * c:8 * c + 8, f]
    return dst


def score16_from(tile, d):
    """gcn_bf16.cu's score16_from: a resident bfloat16 node tile -> the
    scores' B, [d / 16][NT * 16], K-major over the features."""
    dst = np.full((d // 16, NT * 16), np.nan)
    for u in range(NT * (d // 8)):
        r = (u >> 3) // (d // 8) * 8 + (u & 7)
        q = (u >> 3) % (d // 8)
        off = b_offset(r, (8 * q) % 16)
        dst[q // 2, off:off + 8] = tile[r, 8 * q:8 * q + 8]
    return dst


def test_mix_b_is_the_transposed_node_tile():
    rng = np.random.default_rng(1)
    for d in (64, 128):
        tile = rng.standard_normal((NT, d))
        mix = mix_from(tile, d)
        assert not np.isnan(mix).any()
        # the kernel's pass offset, and a control that must fail
        for offset, want in ((MIX_N * 16, True), (MIX_N * 16 // 2, False)):
            good = True
            # k-step j of the mix (nodes 16 j ..), pass hf (features 32 hf ..)
            for j in range(NT // 16):
                for hf in range(d // MIX_N):
                    got = read_b_tile(mix[j], hf * offset, MIX_N)
                    good &= np.array_equal(
                        got, tile[16 * j:16 * j + 16, hf * MIX_N:(hf + 1) * MIX_N])
            assert good == want
        # the scores' B: k-block q of the features, n = the tile's nodes
        score = score16_from(tile, d)
        assert not np.isnan(score).any()
        for q in range(d // 16):
            assert np.array_equal(read_b_tile(score[q], 0, NT), tile[:, 16 * q:16 * q + 16].T)
        # control: the score layout is not the mix's
        assert not np.array_equal(read_b_tile(score[0], 0, MIX_N), tile[:16, :MIX_N])
