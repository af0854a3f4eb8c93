"""The schedules of the bfloat16 temporal conv's pipelines, modelled on the CPU.

``paddlexde_tpu_torch/ops/csrc/tc_bf16_conv.cuh`` feeds the conv's chains two
ways, both handed over by mbarriers (a phase completes when its arrivals,
and the bytes it expects, are in; a wait names the parity of the phase it
waits for):

- K5 bf16's conv kernel (``attn_bwd_bf16_conv_kernel``): CTA ``b`` of a
  launch with ``jobs`` convs takes job ``b // ctas`` and that job's tiles of
  16 rows ``b % ctas, + ctas, ...`` (``attn.bf16_conv_ctas``). A producer
  fills a ring of x tiles (tile n in stage n % ST, ST = 2 at D = 128, 4 at
  64): it waits for the consumers to be done with the stage's previous tile
  (parity (n / ST - 1) & 1), fills it and arrives on ``full``; the three
  consumer warpgroups wait on ``full`` (parity (n / ST) & 1), run the tile
  and arrive on ``empty``. The consumers cover the outputs in halves of 64,
  each reading the bank's B tiles 1024 elements further per half.
- K4 bf16 (``conv_ring``): the four convs' weight chunks (4 D / 16,
  contiguous) through a ring of 3 stages, chunk g in stage g % 3; thread 0
  (of consumer warpgroup 0) issues chunk g + 2 after its chain of chunk g,
  once every thread is done with chunk g - 1; one CTA barrier per conv.

This file walks those schedules in numpy with random interleavings of the
actors (the producer, the consumer warpgroups, the copy engine) and checks
that every (job, tile) is taken once, that every consumer reads the tile or
chunk it expects and no stage is overwritten while in use, that the ring
runs on across K4's convs, and that an output half reads the weights of its
outputs. Controls: a consumer waiting on the wrong parity, a refill that
does not wait for its stage, and a half offset of the wrong size must each
be caught.
"""

import numpy as np

from paddlexde_tpu_torch.ops import attn

T, K, ROWS, KC, HALF, RING = 12, 3, 16, 16, 64, 3


class Barrier:
    """An mbarrier: ``count`` arrivals and the expected bytes complete a
    phase; ``passed(parity)`` is ``mbarrier.try_wait.parity``."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def arrive(self, expect=0):
        self.tx += expect
        self.pending -= 1
        self._check()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._check()

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


def conv_tiles(rows, jobs, sms):
    """{CTA: [(job, tile), ...]} as the conv kernel walks them."""
    ctas = attn.bf16_conv_ctas(rows, jobs, sms)
    tiles = -(-rows // ROWS)
    walk = {}
    for b in range(jobs * ctas):
        job, first = divmod(b, ctas)
        ntiles = (tiles - 1 - first) // ctas + 1 if first < tiles else 0
        walk[b] = [(job, first + n * ctas) for n in range(ntiles)]
    return ctas, walk


def conv_cta(ntiles, stages, rng, parity_shift=0):
    """One conv CTA's x-tile ring: the producer and three consumer
    warpgroups. Returns (no deadlock, every read was the expected tile)."""
    ring = [None] * stages
    full = [Barrier(1) for _ in range(stages)]
    empty = [Barrier(3) for _ in range(stages)]
    ok = [True]

    def producer():
        for n in range(ntiles):
            st = n % stages
            if n >= stages:
                yield lambda st=st, n=n: empty[st].passed((n // stages - 1) & 1)
            ring[st] = None  # the copies land over time
            yield None
            ring[st] = n
            full[st].arrive()

    def consumer():
        for n in range(ntiles):
            st = n % stages
            yield lambda st=st, n=n: full[st].passed((n // stages + parity_shift) & 1)
            for _ in range(2):  # two output halves, each reading the tile
                ok[0] &= ring[st] == n
                yield None
            empty[st].arrive()

    done = run([producer()] + [consumer() for _ in range(3)], rng)
    return done, ok[0]


def k4_ring(chunks, rng, refill_wait=True):
    """K4's weight ring over its four convs of ``chunks`` chunks each: three
    consumer warpgroups, thread 0 of the first issuing, the copy engine
    landing copies in any order. Returns (no deadlock, every chain read its
    chunk until its arrival, {chunk: (stage, conv during which it was
    issued)})."""
    total = 4 * chunks
    ring = [None] * RING
    full = [Barrier(1) for _ in range(RING)]
    empty = [Barrier(3) for _ in range(RING)]
    copies, issued, ok = [], {}, [True]
    at_conv = [0]
    cta_barrier = {"arrived": 0, "gen": 0}

    def issue(c):
        st = c % RING
        if c >= RING and refill_wait:
            yield lambda: empty[st].passed((c // RING - 1) & 1)
        full[st].arrive(expect=1)
        ring[st] = None
        copies.append((c, st))
        issued[c] = (st, at_conv[0])

    def engine():
        for _ in range(total):
            yield lambda: bool(copies)
            c, st = copies.pop(rng.integers(len(copies)))
            ring[st] = c
            full[st].complete_tx(1)

    def consumer(w):
        if w == 0:
            for c in range(RING - 1):
                yield from issue(c)
        yield from sync()
        for conv in range(4):
            at_conv[0] = max(at_conv[0], conv)
            for ci in range(chunks):
                g = conv * chunks + ci
                st = g % RING
                yield lambda st=st, g=g: full[st].passed((g // RING) & 1)
                ok[0] &= ring[st] == g
                yield None  # the chain runs
                ok[0] &= ring[st] == g
                empty[st].arrive()
                if w == 0 and g + RING - 1 < total:
                    yield from issue(g + RING - 1)
            yield from sync()

    def sync():
        gen = cta_barrier["gen"]
        cta_barrier["arrived"] += 1
        if cta_barrier["arrived"] == 3:
            cta_barrier["arrived"], cta_barrier["gen"] = 0, gen + 1
        yield lambda: cta_barrier["gen"] != gen

    done = run([consumer(w) for w in range(3)] + [engine()], rng)
    return done, ok[0], issued


def test_conv_ctas_take_every_job_tile_once():
    # fewer tiles than SMs per job; PEMS08 (340 tiles); a ragged count; many
    # tiles a CTA; a card with few SMs
    for rows, sms in ((5, 132), (400, 132), (5440, 132), (921, 132), (14128, 132), (5440, 8)):
        tiles = -(-rows // ROWS)
        for jobs in (4, 3):
            ctas, walk = conv_tiles(rows, jobs, sms)
            assert 1 <= ctas <= tiles and jobs * ctas <= max(sms, jobs)
            taken = [jt for cta in walk.values() for jt in cta]
            assert sorted(taken) == [(j, t) for j in range(jobs) for t in range(tiles)]
            assert all(min(ROWS, rows - t * ROWS) > 0 for _, t in taken)
            # shared out evenly: a CTA's count differs from another's by at most one
            counts = [len(c) for c in walk.values()]
            assert max(counts) - min(counts) <= 1


def test_rings_hand_over_stages_in_order():
    rng = np.random.default_rng(0)
    # K5's x-tile ring at D = 128 (2 stages) and 64 (4), tile counts from
    # one to past several laps of the ring
    for stages in (2, 4):
        for ntiles in (1, 2, 3, 5, 11):
            for _ in range(20):
                assert conv_cta(ntiles, stages, rng) == (True, True)
    # control: consumers waiting on the other parity read tiles not yet in
    assert any(conv_cta(5, 2, rng, parity_shift=1) != (True, True) for _ in range(20))

    # K4's weight ring at D = 128 (8 chunks a conv) and 64 (4)
    for chunks in (8, 4):
        for _ in range(20):
            done, ok, issued = k4_ring(chunks, rng)
            assert done and ok
            assert sorted(issued) == list(range(4 * chunks))
            assert all(st == c % RING for c, (st, _) in issued.items())
            # the next conv's first two chunks go out before it starts
            for conv in range(1, 4):
                for c in (conv * chunks, conv * chunks + 1):
                    assert issued[c][1] < conv
    # control: a refill that does not wait for its stage overwrites a chunk
    # still in use
    assert any(not k4_ring(8, rng, refill_wait=False)[1] for _ in range(20))


def b_offset(n, k):
    """tc_bf16.cuh's b_offset: K-major core matrices of 8 outputs x 8 inputs."""
    return (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8


def read_b_tile(bank, start, n_out):
    """The [16 inputs x n_out outputs] B tile a wgmma descriptor at element
    ``start`` reads: core matrices of 8 outputs x 8 inputs (16-byte rows),
    the two along the inputs 128 bytes apart, output groups 256 apart."""
    tile = np.empty((KC, n_out), dtype=bank.dtype)
    for n in range(n_out):
        for k in range(KC):
            tile[k, n] = bank[start + (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8]
    return tile


def test_output_halves_read_their_outputs_weights():
    rng = np.random.default_rng(1)
    for d in (64, 128):
        w = rng.standard_normal((K, d, d))
        blk = d * KC
        bank = np.zeros(K * d * d)
        for j in range(K):
            for c in range(d):
                for f in range(d):
                    bank[((c // KC) * K + j) * blk + b_offset(f, c % KC)] = w[j, c, f]
        half_offset = (HALF // 8) * 128
        for offset, want_ok in ((half_offset, True), (HALF * KC // 2, False)):
            ok = True
            for half in range(d // HALF):
                for ci in range(d // KC):
                    for j in range(K):
                        got = read_b_tile(bank, (ci * K + j) * blk + half * offset, HALF)
                        want = w[j, ci * KC:(ci + 1) * KC, half * HALF:(half + 1) * HALF]
                        ok &= np.array_equal(got, want)
            # at D = 64 there is one half, and any offset passes
            assert ok == (want_ok or d == HALF)
