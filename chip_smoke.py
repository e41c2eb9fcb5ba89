"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                # one card: build, kernels, slice (serial, threaded, lanes), K8, int64, committee, mesh (serial, threaded)
    python3 chip_smoke.py --cross-card   # two or more cards: the kernels on each
    python3 chip_smoke.py --mesh         # four cards: K5/K7 and the mesh cell over them (serial, threaded)
    python3 chip_smoke.py --localnet     # one card: the LocalNet cell alone

1. Builds the CUDA sources of txflow_tpu_torch/csrc with nvcc (one process
   per source, in parallel) and prints the card and the build time.
2. Kernels: holds each hand-written kernel against its plain PyTorch
   version on the card, bit-exact (integers and bools: tolerance 0):
   K1 field ops on 4096 seeded elements (0, p-1, p, p+18, 2^255-1
   included) and K1's raw products (fe_prod: mul, sq, mul_small by 2) on
   4096 inputs at the edges of their bounds (every limb at +3 or -3
   carried units, random signs at 3 units, sums of two carried values,
   canonical values), K2 double-scalar multiply + encode on 256 scalar pairs, K3
   verify and K4 tally on one 16384-vote batch holding corrupted R and S,
   S >= L, wrong-chain signatures, an off-curve key, a non-canonical R,
   duplicates, padding rows and nonzero prior stake; K3 also against the
   golden model on a sample. Times each (many launches between one pair
   of CUDA events, over their number, after warmup) beside its plain
   version (median of CUDA-event windows) and its bound (a radix-2^25.5
   squaring at fe.MADS_PER_SQ multiply-adds, a product at MADS_PER_MUL;
   bound_ms_sq_as_mul beside it counts a squaring as a product).
3. Slice: one node's fast path -- a 16-validator set with unequal stake,
   4096 txs in the mempool, 65,536 signed TxVotes (about 1/8 byzantine)
   through TxVotePool -> TxFlow.step() (max_batch 16384) -> TxStore + the
   kvstore app -- and checks the outcome known by construction: exactly
   the txs whose honest stake reaches quorum commit, every certificate
   holds only valid votes worth at least quorum, the app holds exactly
   those keys, one fused verify + tally launch (txf_verify_tally) a step
   and no verify alone or standalone tally, and no host verify ran.
4. Committee certificates (K6, the verify kernel launched alone over one
   committee's unpadded tables): the README's committee configuration --
   256 validators at power 10, EpochConfig(length=1, committee_size=32),
   chain txflow-bench -- with 131,072 votes of the two committees of vote
   heights 0 and 1 over 4096 txs (about 1/8 byzantine). K6 is held
   against its plain version at rungs 8, 64, 1024 and 8192 and timed over
   many launches. Then a serving TxFlow mounting BatchCertVerifier drains
   the height-0 votes (one K6 launch a step), rotates to the epoch-1
   committee (update_state restages the tables on the card) and drains the
   height-1 votes; a follower with its own stores walks the server's
   commit log through serve_range -> the sync wire format ->
   SyncManager, refuses three tampered responses as byzantine with nothing
   applied, and re-verifies (one K6 launch per epoch group) and applies
   the rest. Checks: the committed set known by construction, the
   rotation, the follower's certificate rows, order and app state equal
   to the server's, and every certificate batch through K6 (no host
   verify). Prints the phase's JSON line before the kernels' line.

5. Mesh (K5, K7): BASELINE config 4 -- a 64-validator net (powers
   10 * (1 + i mod 4)) with mixed honest and byzantine signatures, its 1M
   in-flight txs cut to 4096: 262,144 votes, about 1/8 byzantine in the
   three ways above, shuffled -- through TxFlow.step() with
   EngineConfig(max_batch=65536, max_slots=4096, mesh_devices=4) on a
   DeviceVoteVerifier over 4 shards laid round-robin over the visible
   cards (on one card, 4 shards on it): 4 steps of 4 x 16384 rows, each
   shard's fused verify + partial tally (txf_verify_tally's partial form)
   on its card, the partials crossing by peer copies to the first card,
   one reduce there with the prior, the result copied to every other
   shard. On the first
   step's votes, in the same count of launches, the K5 entry points
   (sharded_verify_and_tally over the mesh, verify_batch on one shard's
   worth) and the ring step. Checks: the committed set known by
   construction, 4 fused launches and 1 reduce a sharded step, K5 and the ring equal
   to the construction; then the one-card engine (max_batch 65536) on the
   same votes must give identical certificate bytes and app digest. K5
   and the K7 kernels (partial tally, reduce-quorum, ring hop, the whole
   sharded step) are held bit-exact against their plain versions at those
   shapes and timed. Prints the phase's JSON line before the kernels'.

6. The radix-2^13 field (K8) and the int64 tally, between phases 3 and 4
   (the committee's part inside phase 4): K8 under every kernel of the
   verify13 library -- fe13_ops on 4096 elements, K8's raw products
   (fe13_prod through verify13's txf_fe_prod: mul, sq, mul_small by 2) on
   4096 normalized inputs at the edges of their bound (every limb 9408, 0,
   alternating, uniform, fe_add/fe_sub outputs), dsm_encode13 on 256
   pairs, verify13 (K3 over K8) over the whole K3 batch and
   verify_tables13 (K5 over K8) on a sub-batch, bit-exact against their
   plain versions and mask-equal to the radix-25 kernels -- with an A/B
   line of K3 against verify13 at 16384 rows in turns, beside each
   library's registers and spill bytes from ptxas (every verify13 kernel's
   too); each K8 row's bound counts a radix-2^13 squaring at
   fe13.MADS_PER_SQ, bound_ms_sq_as_mul at a product's cost; the slice again with
   EngineConfig(fe_radix=13) (certificate bytes and app digest equal to
   the radix-25 run's), and in the same launch count one radix-13 sharded
   step over the round-robin mesh (equal to the radix-25 packed output)
   and K5 over K8 through sharded_verify_and_tally; a second follower
   re-verifying the committee log over K8 (K6 rows over K8 at rungs 8 and
   16384); and the slice with every power times 2^25 (total past 2^30:
   txf_verify_tally64 on one card; on the same batch the engine's verifier
   and a 4-shard one, txf_verify_tally64's partial + txf_reduce_quorum64, equal to
   ScalarVoteVerifier), the int64 kernels held bit-exact and timed.

7. The four-lane txf_verify (K3, and K6's launch), between phases 2 and
   3: held bit-exact against its plain version in both fields at 8, 64,
   1000, 1024 and 16384 rows of the K3 batch, each rung holding rows that
   failed their pre-checks, an off-curve key's row with its pre-check
   forced true (identity tables), R = 1 and the non-canonical R = p + 1,
   and rows with an all-zero scalar quarter. Then K5 (txf_verify_tables:
   four lanes a row, one coordinate of the accumulator a lane) on the
   same rows at 64 and 16384 rows in both fields (tables gathered per
   vote): bit-exact against its plain version, its mask equal to K3's,
   and an A/B in turns of K3 against K5 at each, beside both kernels'
   ptxas registers and spill bytes; in phase 4 an A/B of K6 at rung 8
   against K5 on the same 8 rows (both fields); in phase 5 the in-place
   ring hop (txf_add) and torch.add in turns, 500 launches a window, and
   the host launch path split into its pieces. The K2 and K5 rows carry
   the unchanged one-lane bound and, beside it, the products the four
   lanes issue and a lane's chain (COORD_NOTE).

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Any failure raises (exit code != 0), and
without CUDA the script exits 1 before printing any result.

``--cross-card`` runs only the per-card check: each card gets its own
copy of the base tables (curve.device_base_quarters), so K1, K2 and K3
run on every visible card, the last card first, each held against its
plain version on the CPU and K3 also against the golden model.

8. The threaded engine, after phase 3 and after phase 5: the slice cell's
   votes, then the mesh cell's, as fresh copies (cold sign-bytes caches)
   through TxFlow.start() until quiescent, then stop():
   EngineConfig(pipeline_depth=2, pipeline_commits=True, staging_ring=2,
   host_prep_backend="process", host_prep_workers=os.cpu_count()). start()
   builds the kernels and runs one all-padding warm step; the loop keeps
   two tickets in flight, a committer thread commits, worker processes
   encode sign bytes and run the compact prep, and each ticket (four parts
   on the mesh) reads back on a side CUDA stream into pinned memory.
   The slice runs once more with pipeline_commits=False (commits inline
   on the loop thread), what the committer thread costs or saves, and then
   serially again on cold copies: serial, threaded, threaded, serial in
   one call. Every timed run starts after gc.collect() and reports the
   collector's seconds.
   Checks: certificate rows and app digest equal to the serial engine's
   (phase 3's run; the one-card engine of phase 5), every readback through
   the side stream (sync_readbacks 0), one fused verify + tally launch a
   ticket and the warm step (on the mesh one a shard, one reduce a step),
   and stop() leaving no thread, worker, segment or ring. Prints wall time
   and committed votes/s beside the serial engine's of this call, the
   first step's time against the rest, busy seconds per thread, the prep
   pool's wait, the ring's hidden_s and the device's busy share.

9. Lanes, after phase 8's slice runs: the JAX engine's default served path
   on the slice cell with every 8th tx carrying the fee prefix ``fee=10;``
   (512 txs, 8192 votes in the priority lane), the pools wired as a node
   wires them (FeeLaneClassifier on the mempool, the vote pool asking the
   mempool for each vote's lane) before any ingest. The serial engine runs
   first (the reference), then TxFlow.start() with the JAX defaults
   (coalesce, coalesce_linger 4 ms, lane_split, priority_linger 1 ms,
   priority_bucket_cap 512, min_batch 256, max_batch 16384, max_slots
   4096, pipeline_depth 2, the committer, process host prep) three times
   on cold vote copies: a backlog (every vote in the pool before start()),
   a feeder thread at 10,000 votes/s (check_tx_many in chunks of 100, the
   corpus' shuffled order), and the same feed with speculative_commit.
   Checks: certificate rows and delivered txs equal the serial engine's,
   the app state its own delivery log folded, priority batches, every bulk
   drain a coalescer target or a counted flush, one fused verify + tally
   launch a ticket and a warm step, no
   host verify, speculative commits in the third run, stop() leaving
   nothing. Prints per run wall time, committed votes/s, the coalescer's
   and the lanes' counters, batches per rung with each rung's first step
   against the rest, device ms and busy share, GC seconds, and under the
   feed the commit latency per lane (a tx's DeliverTx minus the feed time
   of its certificate's last vote), p50 and p99. K3 is then held against
   its plain version and timed at every rung the phase dispatched, one
   kernel row each.

10. The fused verify + tally (after phase 7): txf_verify_tally and
   txf_verify_tally64, the tally (K4) or a shard's partial (K7) carried by
   txf_verify's encode launch (the last block to finish compares with the
   quorum), held bit-exact against compact_step_packed's plain version at
   64 and 16384 rows of the K3 batch over its 4096 slots, in int32 and
   int64, over both fields, and the partial form on a quarter of each;
   then an A/B in turns (txf_verify alone, fused, fused, alone) at 64 and
   16384 rows (int64 at 16384, the partial at 4096) with torch.profiler's
   kernel bodies beside the event windows. Every engine path requires one
   fused launch a served or warm step in its field and width (on a mesh:
   one a shard, and one reduce a step) and no standalone tally launch;
   the small kernels' rows split their time into kernel body (profiler)
   and host enqueue.

11. Gossip and the fast-path node, after phase 9: BASELINE config 2 by
   bench.py's protocol -- a LocalNet of 4 validators at power 10 (quorum
   27 of 40), 4 nodes over in-memory pipes in a full mesh (p2p switch,
   mempool and txvote reactors), one DeviceVoteVerifier on the card with
   shared_cache=True (buckets 4096 and 16384; each engine's claimed miss
   set through txf_verify alone, the tally on the host) serving the four
   engines, which share its process host-prep pool; sign=False,
   mempool_broadcast=False. 25,000 txs x 4 validators = 100,000 votes,
   signed before the timed loop, with config 4's check mix: 1/16 of the
   txs carry validator 0's vote with a flipped S byte (they commit without
   it), another 1/16 validators 0 and 1 (they commit nowhere). The loop
   seeds each chunk of 2048 txs into every mempool, then validator v's
   votes of the chunk into node v's vote pool, and ends when every node
   committed every tx that should commit. Checks: exactly those txs on
   every node, no corrupted vote in a certificate and each over 2/3 of the
   stake, the four kvstore states equal, verify launches above 0 with no
   fused step, no plain version and no host verify, and the verified rows
   at most the distinct votes. Prints {"localnet": ...} (committed votes/s
   summed over nodes, p50/p99 commit latency from a chunk's injection to
   each node's commit event, wall, the card's busy time over the loop
   (every kernel and copy in a CUDA-only torch.profiler trace, by name)
   and its share, GC seconds, CPU seconds by thread, the cache's counters,
   the launches); the K3 and K6 rows carry its verify launches in
   launches_by_path.

``--mesh`` runs only phase 5, its kernel rows and the threaded mesh cell,
over 4 distinct cards: the engine builds its own mesh from mesh_devices=4
(make_mesh).

Parent-against-this comparisons (the small kernels' launch times, every
phase's certificates and app digests) are txflow_tpu_torch/parent_ab.py.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import random
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from txflow_tpu_torch.abci import AppConns, KVStoreApplication
from txflow_tpu_torch.admission import FeeLaneClassifier
from txflow_tpu_torch.committee import BatchCertVerifier, CommitteeSchedule
from txflow_tpu_torch.committee.certverify import _rung
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.engine import TxExecutor, TxFlow
from txflow_tpu_torch.epoch import EpochConfig
from txflow_tpu_torch.ops import _lib, curve, ed25519_batch, fe, fe13, field, tally
from txflow_tpu_torch.parallel import mesh as mesh_mod
from txflow_tpu_torch.parallel import (
    Mesh, make_mesh, sharded_compact_step_packed, sharded_ring_step, sharded_verify_and_tally,
    to_host,
)
from txflow_tpu_torch.pool import Mempool, TxVotePool
from txflow_tpu_torch.state import StateStore
from txflow_tpu_torch.store import MemDB, TxStore
from txflow_tpu_torch.store.tx_store import _decode_votes, _encode_votes
from txflow_tpu_torch.sync import SyncConfig, SyncError, SyncManager, serve_range, wire
from txflow_tpu_torch.types import MockPV, TxVote, Validator, ValidatorSet
from txflow_tpu_torch.types.tx_vote import canonical_sign_bytes
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig
from txflow_tpu_torch.verifier import (
    DeviceVoteVerifier, ScalarVoteVerifier, bucket_size, first_occurrence_mask,
)

CHAIN_ID = "txflow-smoke"
HEIGHT = 1
SEED = 20261017
N_VALS = 16
N_TXS = 4096
MAX_BATCH = 16384
N_FE = 4096  # K1 elements
N_DSM = 256  # K2 scalar pairs
BAD_PUB = (2).to_bytes(32, "little")  # y = 2 is off the curve
# committee phase: the README's committee acceptance configuration
COM_CHAIN = "txflow-bench"
COM_VALS = 256  # uniform power 10
COM_SIZE = 32  # EpochConfig(length=1, committee_size=32): vote height h -> epoch h
COM_TXS = 2048  # per vote height (0 and 1)
# K6 timing rows; 16384 is a step's rung, 4096 a sync group's
K6_RUNGS = (8, 64, 1024, 4096, 8192, 16384)
# mesh phase: BASELINE config 4, a 64-validator net with mixed honest and
# byzantine signatures; its 1M in-flight txs cut to 4096 (signing time)
MESH_VALS = 64
MESH_TXS = 4096
MESH_SHARDS = 4
MESH_BATCH = 65536  # EngineConfig.max_batch: 4 steps of 4 shards x 16384 rows
MESH_SLOTS = 4096
# byzantine votes of a tx's 64: mean 8.2 (1/8); 24 or 28 leave it below quorum
MESH_BYZ = (0, 4, 8, 12, 24, 28)
MESH_BYZ_P = (0.25, 0.25, 0.2, 0.15, 0.1, 0.05)
# txf_verify's rows (K3, K6): one counted launch of the wrapper is two
# kernel launches, txf_verify_kernel then txf_verify_encode_kernel; the
# row's ms covers both
VERIFY_LAUNCH_NOTE = {"kernel_launches_per_count": 2,
                      "launch_note": "one counted launch = txf_verify_kernel + txf_verify_encode_kernel"}
# K5 and K2 rows (the coordinate split): one counted launch is two kernel
# launches; the bound keeps the one-lane count of products a signature,
# and beside it stand the products the four lanes issue and a lane's chain
COORD_NOTE = {"kernel_launches_per_count": 2,
              "launch_note": "one counted launch = txf_coord_dsm_kernel + an encode kernel",
              "bound_muls_per_signature": curve.MULS_PER_DSM_ENCODE,
              "issued_muls_per_signature": curve.MULS_PER_COORD_DSM_ENCODE,
              "lane_chain_muls": curve.MULS_CHAIN_COORD_DSM_ENCODE}
# lanes phase: every 8th tx of the slice cell carries the fee prefix (512
# txs, 8192 votes in the priority lane); the feed rate is about half the
# threaded slice's backlog rate (21,835 votes/s, NVIDIA H100 80GB HBM3 at
# 700 W), in chunks of 100 votes
LANE_FEE = b"fee=10;"
LANE_FEE_EVERY = 8
LANE_RATE = 10_000  # votes/s
LANE_CHUNK = 100
# LocalNet phase: BASELINE config 2 -- 4 validators at power 10 on 4
# hosted nodes, 25,000 txs x 4 = 100,000 votes, seeded and injected in
# chunks of 2048 txs (bench.py's protocol); the shared verifier's buckets
# are bench.py's (BENCH_BUCKET 4096 and 4x); the four engines share one
# process host-prep pool
NET_CHAIN = "txflow-bench"
NET_POWER = 10
NET_TXS = 25_000
NET_CHUNK = 2048
NET_BUCKET = 4096
NET_PREP_WORKERS = 8
# the standalone tally kernels: no served step launches them (the tally
# rides in the fused verify's encode launch, fused_kernel)
STANDALONE_TALLY = ("tally", "tally64", "tally_partial", "tally_partial64")
# published HBM rates (NVIDIA data sheets); SXM is the default
HBM_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}


def log(*a):
    print(*a, flush=True)


def fused_kernel(fe_radix: int = 25, wide: bool = False, partial: bool = False) -> str:
    """The ``_lib.launches`` name of the fused verify + tally entry: the
    field's library, the quorum form (one card) or a shard's partial (a
    mesh), the int32 or int64 tally."""
    return ("verify" + ("13" if fe_radix == 13 else "") + ("_partial" if partial else "_tally")
            + ("64" if wide else ""))


def require_launches(launches: dict, want: dict, label: str, none_of=()) -> None:
    """Exactly ``want`` launches of each kernel it names, and none of
    ``none_of``."""
    got = {k: launches[k] for k in want}
    bad = {k: launches[k] for k in none_of if launches[k]}
    require(got == want and not bad,
            f"{label}: launches {got}, want {want}; launched and should not be: {bad}")


def card_info() -> dict:
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    name = torch.cuda.get_device_name(0)
    hbm = next((v for k, v in HBM_BYTES_PER_S.items() if k in name), HBM_BYTES_PER_S["SXM"])
    # 32-bit integer multiply-add: 64 results per clock per SM on compute
    # capability 9.0 (CUDA C++ Programming Guide, arithmetic throughput)
    imad_per_s = 64 * props.multi_processor_count * float(clk) * 1e6
    return {"smi": q, "name": name, "sms": props.multi_processor_count,
            "max_sm_mhz": float(clk), "hbm_bytes_per_s": hbm, "imad_per_s": imad_per_s}


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median per-call milliseconds of ``fn`` by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def cuda_ms_window(fn, launches: int, warmup: int = 2, devices=None) -> float:
    """Milliseconds per call of ``fn``: ``launches`` calls between one pair
    of CUDA events, divided by their number (a window around one launch
    reads the host's launch path more than the kernel). With ``devices``,
    a pair of events on each card's current stream, the slowest card's
    window kept (a step that runs on several cards)."""
    cards = list(devices) if devices else [torch.device("cuda", torch.cuda.current_device())]
    for _ in range(warmup):
        fn()
    for c in cards:
        torch.cuda.synchronize(c)
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in cards]
    for (e0, _), c in zip(pairs, cards):
        e0.record(torch.cuda.current_stream(c))
    for _ in range(launches):
        fn()
    for (_, e1), c in zip(pairs, cards):
        e1.record(torch.cuda.current_stream(c))
    for c in cards:
        torch.cuda.synchronize(c)
    return max(e0.elapsed_time(e1) for e0, e1 in pairs) / launches


def bound_ms(card: dict, nbytes: float, mads: float) -> tuple[float, str]:
    t_bytes = nbytes / card["hbm_bytes_per_s"] * 1e3
    t_ops = mads / card["imad_per_s"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# The vote corpus (host work, outside every timed window)


class Corpus:
    """``n_vals`` validators with powers 10 * (1 + i mod 4), ``n_txs`` txs,
    one vote per (tx, validator); about 1/8 of the votes byzantine (a
    flipped signature byte, or a wrong-chain signature as
    MockPV(break_tx_vote_signing=True) makes), ``byz[k]`` of them on a tx
    with probability ``byz_p[k]``, spread so that some txs stay below
    quorum. The defaults are the slice cell's 16 validators. With
    ``fee_every`` k, every k-th tx carries the fee prefix ``fee=10;`` (the
    priority lane of the admission classifier)."""

    def __init__(self, seed: int, n_vals: int = N_VALS, n_txs: int = N_TXS,
                 byz=tuple(range(6)), byz_p=(0.2, 0.2, 0.2, 0.2, 0.1, 0.1),
                 prefix: bytes = b"stx", fee_every: int = 0):
        rng = np.random.default_rng(seed)
        self.n_vals, self.n_txs = n_vals, n_txs
        self.seeds = [rng.bytes(32) for _ in range(n_vals)]
        pubs = [host_ed.public_key_from_seed(s) for s in self.seeds]
        vals = [Validator.from_pub_key(p, 10 * (1 + i % 4)) for i, p in enumerate(pubs)]
        self.val_set = ValidatorSet(vals)
        seed_of = {Validator.from_pub_key(p, 1).address: s for p, s in zip(pubs, self.seeds)}
        # validator-index order (sorted by address), as the engine sees it
        self.val_seeds = [seed_of[v.address] for v in self.val_set]
        self.powers = [v.voting_power for v in self.val_set]
        self.quorum = self.val_set.quorum_power()
        self.txs = [(LANE_FEE if fee_every and i % fee_every == 0 else b"") + prefix
                    + b"%05d=%d" % (i, i) for i in range(n_txs)]
        # byzantine votes per tx (slice cell: 0..5 of 16, mean 2 = 1/8)
        n_byz = np.asarray(byz)[rng.choice(len(byz), size=n_txs, p=list(byz_p))]
        self.votes: list[TxVote] = []
        self.byzantine: list[bool] = []
        self.kind: list[str] = []
        msgs = []
        for t, tx in enumerate(self.txs):
            key = hashlib.sha256(tx).digest()
            byz_v = set(rng.choice(n_vals, size=int(n_byz[t]), replace=False).tolist())
            for v in range(n_vals):
                vote = TxVote(HEIGHT, key.hex().upper(), key, 1_700_000_000_000_000_000 + t,
                              self.val_set.validators[v].address)
                kind = "honest"
                chain = CHAIN_ID
                if v in byz_v:
                    kind = ("flip_r", "flip_s", "wrong_chain")[int(rng.integers(3))]
                    if kind == "wrong_chain":
                        chain = "incorrect-chain-id"
                msgs.append((self.val_seeds[v], vote.sign_bytes(chain)))
                self.votes.append(vote)
                self.byzantine.append(v in byz_v)
                self.kind.append(kind)
        t0 = time.perf_counter()
        sigs = _sign_all(msgs)
        self.sign_s = time.perf_counter() - t0
        for vote, sig, kind in zip(self.votes, sigs, self.kind):
            if kind == "flip_r":
                sig = sig[:7] + bytes([sig[7] ^ 0x10]) + sig[8:]
            elif kind == "flip_s":
                sig = sig[:45] + bytes([sig[45] ^ 0x01]) + sig[46:]
            vote.signature = sig
        # the wrong-chain votes are what MockPV(break_tx_vote_signing=True)
        # signs: check on a few
        for i in [i for i, k in enumerate(self.kind) if k == "wrong_chain"][:4]:
            v = self.votes[i]
            twin = TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address)
            vi = self.val_set.index_of(v.validator_address)
            MockPV(self.val_seeds[vi], break_tx_vote_signing=True).sign_tx_vote(CHAIN_ID, twin)
            require(twin.signature == v.signature, "wrong-chain vote != MockPV(break)")
        # expected outcome by construction: honest stake >= quorum commits
        honest = np.zeros(n_txs, np.int64)
        for i, vote in enumerate(self.votes):
            if not self.byzantine[i]:
                honest[i // n_vals] += self.powers[i % n_vals]
        self.expect_commit = honest >= self.quorum
        # gossip arrival order: shuffled
        self.order = rng.permutation(len(self.votes))


def _sign_all(items: list[tuple[bytes, bytes]]) -> list[bytes]:
    """Sign every (seed, msg) pair over a spawn process pool."""
    import concurrent.futures as cf
    import multiprocessing as mp

    workers = max(1, min(os.cpu_count() or 1, 16))
    chunk = (len(items) + workers * 4 - 1) // (workers * 4)
    parts = [items[i : i + chunk] for i in range(0, len(items), chunk)]
    with cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        return [s for part in ex.map(host_ed.sign_batch, parts) for s in part]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions


def kernel_phase(card: dict, corpus: Corpus, dev) -> tuple[list[dict], dict]:
    rows = []
    rng = np.random.default_rng(SEED + 1)
    P = fe.P_INT
    # K1: field ops on 4096 elements
    edge = [0, 1, P - 1, P, P + 18, 2**255 - 1, 2**255 - 19, 19]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") & (2**255 - 1)
                   for _ in range(N_FE - len(edge))]
    other = vals[1:] + vals[:1]

    def limbs(xs):
        return torch.from_numpy(fe.bytes_to_limbs_np(np.stack(
            [np.frombuffer(x.to_bytes(32, "little"), np.uint8) for x in xs]
        ))).to(dev)

    a, b = limbs(vals), limbs(other)
    k1 = fe.fe_ops(a, b)
    p1 = fe.fe_ops_plain(a, b)
    torch.cuda.synchronize()
    require(bool((k1 == p1).all()), "K1 fe_ops kernel != plain")
    k1h = k1.cpu().numpy()
    for i in (0, 1, 2, 3, 4, 5, N_FE - 1):  # and python ints on the edges
        x, y = vals[i], other[i]
        want = [(x * y) % P, (x * x) % P, (x - y) % P, pow(x, P - 2, P), x % P]
        require([fe.limbs_to_int(r) for r in k1h[i]] == want, f"K1 row {i} != ints")
    ms = cuda_ms_window(lambda: fe.fe_ops(a, b), 50)
    pms = cuda_ms(lambda: fe.fe_ops_plain(a, b), 3)
    bnd, by = bound_ms(card, nbytes(a, b, k1), N_FE * field.mads(25, fe.MULS_PER_FE_OPS, fe.SQS_PER_FE_OPS))
    bnd_sq = bound_ms(card, nbytes(a, b, k1), N_FE * field.mads(25, fe.MULS_PER_FE_OPS, fe.SQS_PER_FE_OPS,
                                                               sq_as_mul=True))[0]
    rows.append(dict(name="K1 fe25519 field ops (fe_ops kernel alone; runs inside txf_verify on the main path)",
                     route="cuda", source="txflow_tpu_torch/csrc/fe25519.cuh",
                     replaces="txflow_tpu/ops/fe.py:103", launched_in="txf_verify",
                     max_abs_err=int((k1 - p1).abs().max()), ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None,
                     shape=f"{N_FE} x (mul,sq,sub,inv,freeze)"))
    log(f"K1 fe_ops: bit-exact over {N_FE} elements; {ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.5f} ms by {by} "
        f"[{bnd_sq:.5f} with a squaring at a product's cost])")

    # K1's raw products on the edges of their input bounds (fe_ops above
    # sees canonical values only): mul, sq and mul_small(., 2), unfrozen,
    # limb for limb against the plain version
    sizes = [N_FE // len(fe.EDGE_KINDS)] * (len(fe.EDGE_KINDS) - 1)
    erng = np.random.default_rng(SEED + 29)  # its own stream: K2-K4's inputs stay as they were
    pairs = [fe.bound_edge_limbs(erng, n_k, kind)
             for n_k, kind in zip(sizes + [N_FE - sum(sizes)], fe.EDGE_KINDS)]
    ea, eb = (torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(*pairs))
    kp = fe.fe_prod(ea, eb)
    pp = fe.fe_prod_plain(ea, eb)
    torch.cuda.synchronize()
    require(bool((kp == pp).all()), "K1 fe_prod kernel != plain on the bound edges")
    ms = cuda_ms_window(lambda: fe.fe_prod(ea, eb), 200)
    pms = cuda_ms(lambda: fe.fe_prod_plain(ea, eb), 3)
    bnd, by = bound_ms(card, nbytes(ea, eb, kp), N_FE * (field.mads(25, 2, 1) + fe.NLIMB))
    bnd_sq = bound_ms(card, nbytes(ea, eb, kp), N_FE * (field.mads(25, 2, 1, sq_as_mul=True) + fe.NLIMB))[0]
    rows.append(dict(name="K1 fe25519 raw products on bound-edge inputs (fe_prod kernel alone: mul, sq, "
                          "mul_small by 2; runs inside txf_verify on the main path)",
                     route="cuda", source="txflow_tpu_torch/csrc/fe25519.cuh",
                     replaces="txflow_tpu/ops/fe.py:103,127,131", launched_in="txf_verify",
                     max_abs_err=int((kp - pp).abs().max()), ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None,
                     shape=f"{N_FE} x (mul, sq, mul_small) over " + ", ".join(fe.EDGE_KINDS)))
    log(f"K1 fe_prod: bit-exact over {N_FE} bound-edge elements ({', '.join(fe.EDGE_KINDS)}); "
        f"{ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.6f} ms by {by} [{bnd_sq:.6f}])")

    # the epoch: 16 validators + one off-curve key, padded to capacity 32
    pubs = [v.pub_key for v in corpus.val_set]
    epoch = ed25519_batch.EpochTables(pubs + [BAD_PUB] + [bytes(32)] * 15, fe_radix=25)
    tables = epoch.device_tables(dev)
    quarters = epoch.device_quarter_tables(dev)
    powers = np.zeros(32, np.int32)
    powers[:N_VALS] = corpus.powers

    # K2: scalar pairs
    s_nib = torch.from_numpy(rng.integers(0, 16, (N_DSM, 64), dtype=np.uint8)).to(dev)
    h_nib = torch.from_numpy(rng.integers(0, 16, (N_DSM, 64), dtype=np.uint8)).to(dev)
    vidx = torch.from_numpy(rng.integers(0, N_VALS, N_DSM).astype(np.int32)).to(dev)
    k2 = curve.dsm_encode(s_nib, h_nib, vidx, tables)
    p2 = curve.dsm_encode_plain(s_nib, h_nib, vidx, tables)
    torch.cuda.synchronize()
    require(bool((k2[0] == p2[0]).all() and (k2[1] == p2[1]).all()), "K2 dsm_encode kernel != plain")
    ms = cuda_ms_window(lambda: curve.dsm_encode(s_nib, h_nib, vidx, tables), 10)
    pms = cuda_ms(lambda: curve.dsm_encode_plain(s_nib, h_nib, vidx, tables), 2)
    k2_bytes = nbytes(s_nib, h_nib, vidx, tables, *k2, curve.device_base_quarters(dev)[0])
    bnd, by = bound_ms(card, k2_bytes, N_DSM * field.mads(25, curve.MULS_PER_DSM_ENCODE, curve.SQS_PER_DSM_ENCODE))
    bnd_sq = bound_ms(card, k2_bytes, N_DSM * field.mads(25, curve.MULS_PER_DSM_ENCODE, curve.SQS_PER_DSM_ENCODE,
                                                         sq_as_mul=True))[0]
    rows.append(dict(name="K2 ge25519 double-scalar multiply + encode (dsm_encode kernel alone, four lanes a "
                          "row by coordinate; the formulas run inside txf_verify on the main path)",
                     route="cuda", source="txflow_tpu_torch/csrc/ge25519.cuh, txflow_tpu_torch/csrc/verify.cu",
                     replaces="txflow_tpu/ops/curve.py:162", launched_in="txf_verify",
                     max_abs_err=int(max((k2[0] - p2[0]).abs().max(), (k2[1] - p2[1]).abs().max())),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq,
                     library_ms=None, shape=f"{N_DSM} pairs", **COORD_NOTE))
    log(f"K2 dsm_encode: bit-exact over {N_DSM} pairs; {ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.5f} ms by {by} "
        f"[{bnd_sq:.5f}])")

    # K3 + K4: one MAX_BATCH-vote batch (about 92% votes, 2% duplicates,
    # the rest padding); sign bytes built aside, so the slice's vote
    # objects keep cold caches
    n_take = MAX_BATCH * 15 // 16
    order = corpus.order[:n_take]
    votes = [corpus.votes[i] for i in order]
    msgs = [canonical_sign_bytes(CHAIN_ID, v.height, v.tx_hash, v.timestamp_ns) for v in votes]
    sigs = [v.signature for v in votes]
    vix = [corpus.val_set.index_of(v.validator_address) for v in votes]
    kinds = [corpus.kind[i] for i in order]
    L = host_ed.L
    for j in range(0, 40):  # S >= L
        s = sigs[j]
        sigs[j] = s[:32] + (int.from_bytes(s[32:], "little") + L).to_bytes(32, "little")
        kinds[j] = "s_ge_l"
    for j in range(40, 60):  # a vote claimed by the off-curve key
        vix[j] = N_VALS
        kinds[j] = "off_curve"
    dup = list(range(100, 100 + n_take // 50))  # duplicates: the same votes again
    msgs += [msgs[j] for j in dup]
    sigs += [sigs[j] for j in dup]
    vix += [vix[j] for j in dup]
    votes += [votes[j] for j in dup]
    kinds += ["dup"] * len(dup)
    n = len(msgs)
    slot_of: dict[str, int] = {}
    slots = np.array([slot_of.setdefault(v.tx_hash, len(slot_of)) for v in votes], np.int32)
    keep = first_occurrence_mask(slots, np.array(vix))
    batch = ed25519_batch.prepare_compact(msgs, sigs, np.array(vix), epoch)
    batch.pre_ok &= keep
    B, S = MAX_BATCH, N_TXS
    require(len(slot_of) <= S, "slots overflow")

    def pad(x, rows_, fill=0):
        out = np.full((rows_,) + x.shape[1:], fill, x.dtype)
        out[: len(x)] = x
        return out

    s_n, h_n = pad(batch.s_nibbles, B), pad(batch.h_nibbles, B)
    v_i, r_y = pad(batch.val_idx, B), pad(batch.r_y, B)
    r_s, ok = pad(batch.r_sign, B), pad(batch.pre_ok, B)
    # two rows of P = [0]B + [0]A = identity (y = 1): canonical R = 1
    # verifies, the non-canonical R = p + 1 does not
    for row, r_val in ((n, 1), (n + 1, P + 1)):
        s_n[row] = 0
        h_n[row] = 0
        r_y[row] = np.frombuffer(r_val.to_bytes(32, "little"), np.uint8)
        ok[row] = True
    slot = pad(slots, B, fill=-1)
    prior = np.zeros(S, np.int32)
    prior[: len(slot_of)] = rng.integers(0, 200, len(slot_of))

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    args = (T(s_n), T(h_n), T(v_i), tables, quarters, T(r_y), T(r_s), T(ok))
    slot_t, prior_t, powers_t = T(slot), T(prior), T(powers)
    k3 = ed25519_batch.verify_kernel_gather(*args)
    p3 = ed25519_batch.verify_kernel_gather_plain(*args)
    torch.cuda.synchronize()
    require(bool((k3 == p3).all()), "K3 verify kernel != plain")
    require(k3[n].item() and not k3[n + 1].item(), "non-canonical R check failed")
    require(not k3[n + 2 :].any().item(), "a padding row verified")
    k3h = k3.cpu().numpy()
    sample = list(range(0, 60)) + list(range(60, n, max(1, n // 200)))
    for j in sample:
        want = (0 <= vix[j] < N_VALS and keep[j]
                and host_ed.verify_pure(pubs[vix[j]], msgs[j], sigs[j]))
        require(bool(k3h[j]) == want, f"K3 row {j} ({kinds[j]}) != verify_pure")
    for kind in ("flip_r", "flip_s", "wrong_chain", "s_ge_l", "off_curve", "dup"):
        idx = [j for j in range(n) if kinds[j] == kind]
        require(len(idx) > 0 and not k3h[idx].any(), f"a {kind} vote verified")
    n_ok = int(ok.sum())
    ms = cuda_ms_window(lambda: ed25519_batch.verify_kernel_gather(*args), 10)
    pms = cuda_ms(lambda: ed25519_batch.verify_kernel_gather_plain(*args), 2)
    k3_bytes = nbytes(*args) + nbytes(curve.device_base_quarters(dev, 25)) + B * 4
    bnd, by = bound_ms(card, k3_bytes, n_ok * ed25519_batch.mads_per_signature(25))
    bnd_sq = bound_ms(card, k3_bytes, n_ok * ed25519_batch.mads_per_signature(25, sq_as_mul=True))[0]
    rows.append(dict(name="K3 ed25519 verify (txf_verify, four lanes a signature)", route="cuda",
                     source="txflow_tpu_torch/csrc/verify.cu",
                     replaces="txflow_tpu/ops/ed25519_batch.py:384",
                     max_abs_err=int((k3.int() - p3.int()).abs().max()), ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None,
                     **VERIFY_LAUNCH_NOTE, shape=f"{B} rows, {n_ok} past the host pre-checks"))
    log(f"K3 verify: bit-exact over {B} rows ({int(k3.sum())} valid, {n_ok} computed); "
        f"{ms:.3f} ms (plain {pms:.1f} ms, bound {bnd:.4f} ms by {by} [{bnd_sq:.4f}])")

    quorum = corpus.quorum
    packed = tally.compact_step_packed(*args[:3], *args[5:], slot_t, tables, quarters, powers_t,
                                       prior_t, quorum)
    stake_p, maj_p = tally.tally_plain(k3, slot_t, args[2], powers_t, prior_t, quorum)
    torch.cuda.synchronize()
    require(bool((packed[:B] == k3.int()).all()), "packed valid != verify")
    require(bool((packed[B : B + S] == stake_p).all() and (packed[B + S :] == maj_p).all()),
            "K4 tally kernel != plain")
    require(bool(maj_p.any()) and bool((prior_t > 0).any()), "tally case too weak")
    valid_i = k3.int()
    stake_k = torch.empty(S, dtype=torch.int32, device=dev)
    maj_k = torch.empty(S, dtype=torch.int32, device=dev)

    def run_tally():
        tally.tally_into(stake_k, maj_k, valid_i, slot_t, args[2], powers_t, prior_t, quorum)

    ms = cuda_ms_window(run_tally, 500, warmup=5)
    one_ms = cuda_ms(run_tally, 50, warmup=5)  # a window around each launch, for comparison
    pms = cuda_ms(lambda: tally.tally_plain(k3, slot_t, args[2], powers_t, prior_t, quorum), 20, warmup=2)
    in_range = (slot_t >= 0) & (slot_t < S)
    slot_c = slot_t.long().clamp(0, S - 1)
    val_c = args[2].long()

    def library_tally():  # the power gather, the mask and index_add + compare
        contrib = torch.where(k3 & in_range, powers_t[val_c], 0)
        return prior_t.index_add(0, slot_c, contrib) >= quorum

    require(bool((library_tally().int() == maj_p).all()), "index_add tally != plain")
    lib_ms = cuda_ms_window(library_tally, 500, warmup=5)
    bnd, by = bound_ms(card, nbytes(valid_i, slot_t, args[2], powers_t, prior_t, stake_k, maj_k),
                       B + S)
    rows.append(dict(name="K4 stake tally, standalone (txf_tally; the fused tally's yardstick)",
                     route="cuda",
                     source="txflow_tpu_torch/csrc/tally.cu",
                     replaces="txflow_tpu/ops/tally.py:114",
                     max_abs_err=int(max((packed[B : B + S] - stake_p).abs().max(),
                                         (packed[B + S :] - maj_p).abs().max())),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                     one_launch_window_ms=one_ms, shape=f"{B} votes, {S} slots"))
    log(f"K4 tally: bit-exact ({int(maj_p.sum())} slots at quorum); {ms:.4f} ms "
        f"({one_ms:.4f} ms in a window around one launch; plain {pms:.3f} ms, index_add_ + compare {lib_ms:.4f} ms, bound {bnd:.6f} ms by {by})")
    rows[-1].update(small_kernel_split(run_tally))
    k3_ms = next(r["ms"] for r in rows if r["name"].startswith("K3"))
    k3_batch = dict(args=args, n=n, n_ok=n_ok, mask=k3, keys=pubs + [BAD_PUB] + [bytes(32)] * 15,
                    k3_ms=k3_ms, slot=slot_t, prior=prior_t, quorum=quorum, powers=powers_t,
                    special=dict(s_ge_l=0, off_curve=40, dup=n - 1, identity_r1=n,
                                 identity_r_p1=n + 1, padding=n + 2))
    return rows, k3_batch


QUARTER_RUNGS = (8, 64, 1000, 1024, 16384)  # 1000: not a multiple of a block's 32 rows
K5_RUNGS = (64, MAX_BATCH)  # K5 (coordinate lanes) against its plain version and K3


def quarter_checks(card: dict, k3: dict, dev, ptx: dict) -> dict:
    """The four-lane txf_verify (K3, and K6's launch) against its plain
    version, bit-exact, in both fields at each of QUARTER_RUNGS rows of
    the K3 batch. Every rung holds a row whose S >= L, an off-curve key's
    row with its pre-check forced true (the kernel then reads that key's
    identity tables), the identity rows with R = 1 (valid) and the
    non-canonical R = p + 1 (invalid), a padding row, a duplicate, and a
    row with an all-zero quarter of s and one of h; the larger rungs fill
    up with the batch's votes. Then K5 (txf_verify_tables, the coordinate
    split) on the same rows and tables, gathered per vote, at K5_RUNGS
    rows in both fields: bit-exact against its plain version, its mask
    equal to K3's, and the A/B in turns (K3, K5, K5, K3) of the two
    four-lane designs, beside both kernels' registers and spill bytes."""
    args25, sp = k3["args"], k3["special"]
    epoch13 = ed25519_batch.EpochTables(k3["keys"], fe_radix=13)
    by_field = {25: args25, 13: (*args25[:3], epoch13.device_tables(dev),
                                 epoch13.device_quarter_tables(dev), *args25[5:])}
    s_n, h_n, ok = args25[0].clone(), args25[1].clone(), args25[7].clone()
    forced = sp["off_curve"] + 1
    ok[forced] = True
    zq_s, zq_h = 60, 61
    s_n[zq_s, 0:16] = 0  # quarter 3 of s
    h_n[zq_h, 48:64] = 0  # quarter 0 of h
    special = [sp["s_ge_l"], forced, sp["identity_r1"], sp["identity_r_p1"], sp["padding"],
               sp["dup"], zq_s, zq_h, sp["off_curve"]]
    # then the batch's votes from row 62 on (rows 0-59 failed their pre-checks)
    rest = [j for j in range(62, MAX_BATCH) if j not in special] + [
        j for j in range(62) if j not in special]
    order = torch.tensor(special + rest, device=dev)
    checks, masks = [], {}
    for r, a in by_field.items():
        full = (s_n, h_n, a[2], a[3], a[4], a[5], a[6], ok)
        for rung in QUARTER_RUNGS:
            sub = order[:rung] if rung < MAX_BATCH else torch.arange(MAX_BATCH, device=dev)
            rows = [full[i][sub] if i not in (3, 4) else full[i] for i in range(8)]
            k = ed25519_batch.verify_kernel_gather(*rows, fe_radix=r)
            p = ed25519_batch.verify_kernel_gather_plain(*rows, fe_radix=r)
            torch.cuda.synchronize()
            require(bool((k == p).all()), f"txf_verify (radix {r}) != plain at {rung} rows")
            pos = {int(j): q for q, j in enumerate(sub.tolist())}
            require(bool(k[pos[sp["identity_r1"]]]) and not bool(k[pos[sp["identity_r_p1"]]]),
                    f"radix {r}, {rung} rows: R = 1 / R = p + 1 rows")
            require(not any(bool(k[pos[sp[x]]]) for x in ("s_ge_l", "padding", "dup")),
                    f"radix {r}, {rung} rows: a row that failed its pre-checks verified")
            if r == 25:
                masks[rung] = k
            require(bool((k == masks[rung]).all()), f"{rung} rows: radix-13 mask != radix-25 mask")
            ms = cuda_ms_window(lambda: ed25519_batch.verify_kernel_gather(*rows, fe_radix=r), 20)
            checks.append({"fe_radix": r, "rows": rung, "valid": int(k.sum()),
                           "computed": int(rows[7].sum()), "max_abs_err": int((k.int() - p.int()).abs().max()),
                           "ms": ms})
            log(f"txf_verify radix {r}, {rung} rows: bit-exact with the plain version "
                f"({int(k.sum())} valid, {int(rows[7].sum())} computed); {ms:.4f} ms")
    # K5 on the same rows (the coordinate split; tables gathered per vote),
    # then the A/B in turns: quarters (K3) against coordinates (K5)
    ab = {}
    names = ("txf_verify_kernel", "txf_verify_encode_kernel<int32>", "txf_coord_dsm_kernel")
    for r, a in by_field.items():
        full = (s_n, h_n, a[2], a[3], a[4], a[5], a[6], ok)
        lib = "verify13" if r == 13 else "verify"
        kr = ptx[lib]["kernels"]
        for rung in K5_RUNGS:
            sub = order[:rung] if rung < MAX_BATCH else torch.arange(MAX_BATCH, device=dev)
            rows = [full[i][sub] if i not in (3, 4) else full[i] for i in range(8)]
            vi = rows[2].long().clamp(0, rows[3].shape[0] - 1)
            k5_args = (rows[0], rows[1], rows[3][vi].contiguous(), rows[5], rows[6], rows[7])
            m3 = ed25519_batch.verify_kernel_gather(*rows, fe_radix=r)
            m5 = ed25519_batch.verify_kernel(*k5_args, fe_radix=r)
            p5 = ed25519_batch.verify_kernel_plain(*k5_args, fe_radix=r)
            torch.cuda.synchronize()
            require(bool((m5 == p5).all()), f"txf_verify_tables (radix {r}) != plain at {rung} rows")
            require(bool((m3 == m5).all()), f"radix {r}, {rung} rows: K3 and K5 masks differ")
            checks.append({"kernel": "txf_verify_tables", "fe_radix": r, "rows": rung,
                           "valid": int(m5.sum()), "computed": int(rows[7].sum()),
                           "max_abs_err": int((m5.int() - p5.int()).abs().max())})
            t = []
            for fn in ("k3", "k5", "k5", "k3"):
                if fn == "k3":
                    t.append(cuda_ms_window(
                        lambda: ed25519_batch.verify_kernel_gather(*rows, fe_radix=r), 10))
                else:
                    t.append(cuda_ms_window(lambda: ed25519_batch.verify_kernel(*k5_args, fe_radix=r), 10))
            n_ok = int(rows[7].sum())
            ab[f"radix{r}_rows{rung}"] = {
                "k3_quarter_lanes_ms": [t[0], t[3]], "k5_coord_lanes_ms": [t[1], t[2]],
                "k5_over_k3": (t[1] + t[2]) / (t[0] + t[3]),
                "k3_bound_ms": bound_ms(card, 0, n_ok * ed25519_batch.mads_per_signature(r))[0],
                "k5_bound_ms": bound_ms(card, 0, n_ok * ed25519_batch.mads_per_signature(
                    r, four_lanes=False))[0],
                "k3_bound_ms_sq_as_mul": bound_ms(card, 0, n_ok * ed25519_batch.mads_per_signature(
                    r, sq_as_mul=True))[0],
                "k5_bound_ms_sq_as_mul": bound_ms(card, 0, n_ok * ed25519_batch.mads_per_signature(
                    r, four_lanes=False, sq_as_mul=True))[0],
                "registers": {k: kr.get(k, {}).get("registers") for k in names},
                "stack_bytes": {k: kr.get(k, {}).get("stack_bytes") for k in names},
                "spill_bytes": {k: kr.get(k, {}).get("spill_bytes") for k in names}}
            log(f"txf_verify_tables radix {r}, {rung} rows: bit-exact with the plain version, "
                f"mask equal to K3's ({int(m5.sum())} valid, {n_ok} computed)")
    log("A/B txf_verify (quarter lanes) vs txf_verify_tables (coordinate lanes), in turns: "
        + json.dumps(ab))
    return {"quarter_checks": checks, "ab_quarters_vs_coordinates": ab}


# ---------------------------------------------------------------------------
# The fused verify + tally (K4, and the K7 partial, in txf_verify's encode
# launch), and the small kernels' time split into kernel body and host enqueue


def kernel_body_ms(fn, calls: int, warmup: int = 2) -> dict:
    """Device milliseconds a call of ``fn`` spends in each kernel (and
    copy) it runs, by name, from torch.profiler's trace of ``calls`` calls
    (each kernel's self device time over their number), with "total"
    their sum. An empty trace or a profiler error is reported as such in
    the result: the event windows time every row regardless."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return trace_device_ms(prof, calls)
    except Exception as e:  # noqa: BLE001 -- a measurement, never a check
        return {"error": repr(e)}


def trace_device_ms(prof, calls: int = 1) -> dict:
    """Each kernel's (and copy's) self device milliseconds in a finished
    torch.profiler trace, by name, over ``calls``, with "total" their sum;
    {"error": ...} when the trace holds no device time."""
    import re

    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            m = re.match(r"(?:void )?([\w:]+(?:<[^(]*>)?)", e.key)
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0.0) + t / 1e3 / calls
    if not out:
        return {"error": "no device time in the trace"}
    out["total"] = sum(out.values())
    return out


def host_enqueue_ms(fn, calls: int = 200) -> float:
    """Host milliseconds a call of ``fn`` takes to enqueue its work (no
    synchronise inside the loop): the rate at which this host can launch
    it, the floor of an event window over many calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def small_kernel_split(fn, calls: int = 200) -> dict:
    """A small kernel's event-window time split: the kernel's body on the
    card (profiler) and the host's enqueue time a call."""
    body = kernel_body_ms(fn, calls)
    return {"kernel_body_ms": body.get("total"), "kernel_body_by_kernel": body,
            "host_enqueue_ms": host_enqueue_ms(fn, calls)}


def _rows_of(args, off: int, rung: int):
    """``rung`` rows of a verify argument tuple (s, h, val_idx, tables,
    quarters, r_y, r_sign, pre_ok) from row ``off``; the tables whole."""
    return tuple(a if i in (3, 4) else a[off : off + rung] for i, a in enumerate(args))


FUSED_RUNGS = (64, MAX_BATCH)


def fused_rows(card: dict, k3: dict, dev) -> tuple[list[dict], dict]:
    """The fused entry (txf_verify_tally / txf_verify_tally64: K3 with K4
    in its encode launch; in the partial form K3 with a shard's K7
    partial) at the rungs of FUSED_RUNGS of the K3 batch (from row 60 at
    64 rows, past the rows that failed their pre-checks; the whole batch at
    16384), over the batch's 4096 slots and its prior moved up to near the
    quorum: held bit-exact
    against compact_step_packed's plain version in int32 and int64 (every
    power and the prior times 2^25) over both fields, and the partial form
    on a quarter of the rung (one of 4 shards) against the plain partial.
    Then the A/B in turns (the verify alone, fused, unfused, unfused,
    fused, the verify alone; unfused: the verify, then the standalone
    tally or partial, the parent's step) at 64 and 16384 rows in int32,
    at 16384 in int64 and for the partial at 4096: CUDA-event windows
    beside torch.profiler's kernel bodies and the host's enqueue time, the
    epilogue's marginal time the fused call less the verify alone.
    Returns (the
    rows, launches to fill in by the caller; the checks and the A/B)."""
    args25, slot, prior, quorum, powers = (k3[k] for k in ("args", "slot", "prior", "quorum",
                                                          "powers"))
    S = prior.shape[0]
    # the prior moved up to [quorum - 190, quorum + 10): some slots at
    # quorum before any vote, some crossing it with one vote
    prior = prior + (quorum - 190)
    scale = 2**25
    powers64 = powers.long() * scale
    prior64 = prior.long() * scale
    quorum64 = (int(powers64.sum()) * 2) // 3 + 1
    widths = {False: (powers, prior, quorum), True: (powers64, prior64, quorum64)}
    epoch13 = ed25519_batch.EpochTables(k3["keys"], fe_radix=13)
    by_field = {25: args25, 13: (*args25[:3], epoch13.device_tables(dev),
                                 epoch13.device_quarter_tables(dev), *args25[5:])}

    def step_args(a, sl, wide):
        pw, pr, q = widths[wide]
        return (a[0], a[1], a[2], a[5], a[6], a[7], sl, a[3], a[4], pw, pr, q)

    checks = []
    for r, args in by_field.items():
        for rung in FUSED_RUNGS:
            off = 60 if rung < MAX_BATCH else 0
            a, sl = _rows_of(args, off, rung), slot[off : off + rung]
            valid = ed25519_batch.verify_kernel_gather_plain(*a, fe_radix=r)
            bs = rung // MESH_SHARDS
            for wide in (False, True):
                sa = step_args(a, sl, wide)
                got = tally.compact_step_packed(*sa, fe_radix=r)
                # compact_step_packed_plain's output, its plain verify made once above
                st_p, mj_p = tally.tally_plain(valid, sl, a[2], *widths[wide])
                want = torch.cat([valid.int(), st_p.view(torch.int32), mj_p])
                pk, part = tally.compact_step_partial(
                    *(x[:bs] for x in sa[:7]), sa[7], sa[8], sa[9], S, fe_radix=r)
                want_part = tally.tally_partial_plain(valid[:bs], sl[:bs], a[2][:bs], sa[9], S)
                torch.cuda.synchronize()
                what = f"fused verify + tally (radix {r}, {rung} rows, {'int64' if wide else 'int32'})"
                require(bool((got == want).all()), f"{what} != plain")
                require(bool((pk[:bs] == valid[:bs].int()).all() and (part == want_part).all()),
                        f"{what}, partial form on {bs} rows != plain")
                stake, maj = tally.packed_stake(got, rung, S, wide)
                require(int(maj.sum()) > 0 and int(valid.sum()) > 0, f"{what}: case too weak")
                checks.append({"fe_radix": r, "rows": rung, "int64": wide, "valid": int(valid.sum()),
                               "slots_at_quorum": int(maj.sum()), "max_stake": int(stake.max()),
                               "max_abs_err": int(max((got - want).abs().max(),
                                                      (part - want_part).abs().max())),
                               "partial_rows": bs})
                log(f"{what}: bit-exact with compact_step_packed's plain version "
                    f"({int(valid.sum())} valid, {int(maj.sum())} slots at quorum, stake up to "
                    f"{int(stake.max())}); the partial form on {bs} rows bit-exact")

    # the A/B in turns: txf_verify alone against the fused entry
    ab, rows = {}, []
    cases = ((64, False, False), (MAX_BATCH, False, False), (MAX_BATCH, True, False),
             (MAX_BATCH // MESH_SHARDS, False, True))
    for rung, wide, partial in cases:
        off = 60 if rung == 64 else 0
        a, sl = _rows_of(args25, off, rung), slot[off : off + rung]
        sa = step_args(a, sl, wide)
        out = torch.empty(rung, dtype=torch.int32, device=dev)
        acc = torch.empty(S, dtype=sa[9].dtype, device=dev)

        pw, pr, q = widths[wide]
        packed = torch.empty(tally.packed_size(rung, S, wide), dtype=torch.int32, device=dev)
        sw = 2 * S if wide else S

        def alone():
            ed25519_batch.verify_into(out, *a)

        if partial:
            def fused():
                tally.compact_step_partial(*sa[:10], S, partial=acc)

            def unfused():  # the parent's partial step: verify, then the standalone partial
                ed25519_batch.verify_into(out, *a)
                tally.tally_partial(out, sl, a[2], pw, S)
        else:
            def fused():
                tally.compact_step_packed(*sa)

            def unfused():  # the parent's step: verify, then the standalone tally
                ed25519_batch.verify_into(packed[:rung], *a)
                tally.tally_into(packed[rung : rung + sw], packed[rung + sw :], packed[:rung], sl,
                                 a[2], pw, pr, q)

        reps = 50 if rung <= 4096 else 10
        # in turns: alone, fused, unfused, unfused, fused, alone
        t = [cuda_ms_window(fn, reps) for fn in (alone, fused, unfused, unfused, fused, alone)]
        body = {"verify_alone": kernel_body_ms(alone, reps), "fused": kernel_body_ms(fused, reps),
                "unfused": kernel_body_ms(unfused, reps)}
        v_ms, f_ms, u_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
        epi_body = (body["fused"]["total"] - body["verify_alone"]["total"]
                    if "total" in body["fused"] and "total" in body["verify_alone"] else None)
        key = f"{'partial' if partial else 'int64' if wide else 'int32'}_{rung}"
        ab[key] = {"rows": rung, "slots": S, "verify_alone_ms": [t[0], t[5]],
                   "fused_ms": [t[1], t[4]], "unfused_ms": [t[2], t[3]],
                   "epilogue_ms": f_ms - v_ms, "saved_ms": u_ms - f_ms,
                   "epilogue_body_ms": epi_body, "kernel_body_ms": body,
                   "host_enqueue_ms": {"verify_alone": host_enqueue_ms(alone, 100),
                                     "fused": host_enqueue_ms(fused, 100),
                                     "unfused": host_enqueue_ms(unfused, 100)}}
        log(f"A/B verify alone vs fused verify + {'partial' if partial else 'tally'} "
            f"({'int64' if wide else 'int32'}, {rung} rows, {S} slots), in turns: "
            + json.dumps(ab[key]))
        n_ok = int(a[7].sum())
        out_bytes = rung * 4 + (pr.numel() * pr.element_size() if partial else
                                tally.packed_size(0, S, wide) * 4)
        f_bytes = (nbytes(*a, sl, pw) + (0 if partial else nbytes(pr)) + out_bytes
                   + nbytes(curve.device_base_quarters(dev, 25)))
        bnd, by = bound_ms(card, f_bytes, n_ok * ed25519_batch.mads_per_signature(25) + rung
                           + (0 if partial else S))
        bnd_sq = bound_ms(card, f_bytes, n_ok * ed25519_batch.mads_per_signature(25, sq_as_mul=True) + rung
                          + (0 if partial else S))[0]
        t0 = time.perf_counter()
        if partial:
            tally.tally_partial_plain(ed25519_batch.verify_kernel_gather_plain(*a), sl, a[2], pw, S)
        else:
            tally.compact_step_packed_plain(*sa)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        what = ("K7 per-shard partial fused into txf_verify's encode launch (txf_verify_tally, "
                "partial form)" if partial else
                f"K4 {'int64 ' if wide else ''}stake tally fused into txf_verify's encode launch "
                f"(txf_verify_tally{'64' if wide else ''}, {rung} rows)")
        err = max(c["max_abs_err"] for c in checks if c["fe_radix"] == 25 and c["int64"] == wide
                  and c["rows"] == (MAX_BATCH if partial else rung))
        rows.append(dict(
            name=what, route="cuda",
            source="txflow_tpu_torch/csrc/verify.cu, txflow_tpu_torch/csrc/tally.cuh",
            replaces="txflow_tpu/parallel/mesh.py:114" if partial else "txflow_tpu/ops/tally.py:114",
            launch_name=fused_kernel(25, wide, partial), max_abs_err=err, ms=f_ms, plain_ms=pms,
            bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None, epilogue_ms=f_ms - v_ms,
            epilogue_body_ms=epi_body, verify_alone_ms=v_ms, **VERIFY_LAUNCH_NOTE,
            shape=f"{rung} rows, {n_ok} past the host pre-checks, {S} slots",
            time_note="ms: the fused call (verify + tally, two kernels); epilogue_ms: it "
                      "less txf_verify alone in turns; plain: one host-clock run"))
    return rows, {"checks": checks, "ab": ab}


# ---------------------------------------------------------------------------
# Phase 3: the slice


def _node(corpus: Corpus, config: EngineConfig, verifier=None, val_set=None, votes=None,
          lanes: bool = False, feed: bool = True, app=None):
    """One node's pools, stores and engine over ``val_set`` (default the
    corpus' set), the corpus' txs in the mempool and, with ``feed``, its
    votes (or ``votes``, copies of them) in the vote pool in arrival order.
    With ``lanes`` the pools are wired as a node wires them before any
    ingest: the fee classifier on the mempool, the vote pool asking the
    mempool for each vote's tx lane. ``app`` replaces the kvstore app."""
    conns = AppConns(app or KVStoreApplication())
    n_txs, n_votes = len(corpus.txs), len(corpus.votes)
    mempool = Mempool(MempoolConfig(size=2 * n_txs, cache_size=4 * n_txs), conns.mempool)
    commitpool = Mempool(MempoolConfig(size=2 * n_txs, cache_size=4 * n_txs))
    votepool = TxVotePool(MempoolConfig(size=2 * n_votes, cache_size=2 * n_votes))
    store = TxStore(MemDB())
    flow = TxFlow(CHAIN_ID, HEIGHT, val_set or corpus.val_set, votepool, mempool, commitpool,
                  TxExecutor(conns.consensus, mempool), store, config=config, verifier=verifier)
    if lanes:
        mempool.lane_of = FeeLaneClassifier(1)
        votepool.lane_of_vote = lambda v: mempool.lane_of_key(v.tx_key)
    require(not any(mempool.check_tx_many(corpus.txs)), "mempool rejected a tx")
    if feed:
        votes = corpus.votes if votes is None else votes
        require(not any(votepool.check_tx_many([votes[i] for i in corpus.order])),
                "vote pool rejected a vote")
    return flow, store, conns.app


class GcClock:
    """Host seconds the cyclic garbage collector ran while installed, and
    its collections by generation (``gc.callbacks``)."""

    def __enter__(self):
        self.s, self.collections, self._t = 0.0, [0, 0, 0], 0.0
        gc.collect()  # every timed run starts with empty young generations
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def _drive(flow, dev) -> dict:
    """TxFlow.step() until the pool is drained: host stages, device time
    per step, step times, the collector's time; the outcome is read by
    the caller."""
    tally_step = tally.compact_step_packed
    stages, device_ms = _time_stages(flow, dev)
    step_s = []
    try:
        with GcClock() as gcc:
            t0 = time.perf_counter()
            while True:
                ts = time.perf_counter()
                if not flow.step():
                    break
                step_s.append(time.perf_counter() - ts)
            wall = time.perf_counter() - t0
    finally:
        tally.compact_step_packed = tally_step
    stage_ms = {k: v * 1e3 for k, v in stages.items()}
    stage_ms["route"] -= stage_ms["commit"]  # commits run inside routing
    return {"steps": len(step_s), "step_s": step_s, "p50_step_ms": statistics.median(step_s) * 1e3,
            "wall_s": wall, "stage_ms_total": stage_ms, "device_ms_per_step": device_ms,
            "device_busy_share": sum(device_ms) / (sum(step_s) * 1e3),
            "gc_s": gcc.s, "gc_collections": gcc.collections}


def _outcome(corpus: Corpus, flow, store, app, scale: int = 1) -> dict:
    """The committed set, certificates and in-flight stake against the
    construction (every power ``scale`` times the corpus'); returns the
    certificate rows and counts."""
    hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in corpus.txs]
    committed = np.array([flow.is_tx_committed(h) for h in hashes])
    require(bool((committed == corpus.expect_commit).all()),
            f"committed {int(committed.sum())} txs, expected {int(corpus.expect_commit.sum())}")
    require(0 < committed.sum() < len(hashes), "the byzantine spread left no tx below quorum")
    want_keys = {tx.split(b"=")[0] for tx, c in zip(corpus.txs, committed) if c}
    require(set(app.state) == want_keys and app.tx_count == int(committed.sum()), "app state")
    byz = {(v.tx_hash, v.validator_address): b for v, b in zip(corpus.votes, corpus.byzantine)}
    power_of = {v.address: v.voting_power for v in flow.val_set}
    quorum = flow.val_set.quorum_power()
    rows, committed_votes = {}, 0
    for h, c in zip(hashes, committed):
        if not c:
            continue
        cert = flow.load_commit(h)
        require(cert is not None, "missing certificate")
        require(not any(byz[(h, cs.validator_address)] for cs in cert.commits),
                "a byzantine vote in a certificate")
        require(sum(power_of[cs.validator_address] for cs in cert.commits) >= quorum,
                "certificate below quorum")
        committed_votes += len(cert.commits)
        rows[h] = store.load_cert_row(h)
    n = corpus.n_vals
    for t in np.flatnonzero(~committed):
        honest = scale * sum(corpus.powers[v] for v in range(n) if not corpus.byzantine[t * n + v])
        require(flow.vote_sets[hashes[t]].stake() == honest, "in-flight stake != honest stake")
    return {"committed_txs": int(committed.sum()), "committed_votes": committed_votes,
            "rows": rows, "digest": app.digest}


def slice_phase(corpus: Corpus, dev, fe_radix: int = 25, scale: int = 1, ref: dict | None = None,
                label: str = "slice", extra=None) -> tuple[dict, dict]:
    """One node's fast path over the corpus, verify over the ``fe_radix``
    field, every power ``scale`` times the corpus' (a scale that takes the
    total past 2^30 runs the int64 tally). Checks the outcome known by
    construction; with ``ref`` (an earlier run's outcome) the certificate
    bytes and the app digest must equal it, else a sample of certificates
    goes through the golden model. ``extra(flow)`` runs between the same
    reset and read of the launch counts (more of this field's path).
    Returns (the phase's numbers, the outcome)."""
    val_set = corpus.val_set if scale == 1 else ValidatorSet(
        [Validator(v.address, v.pub_key, v.voting_power * scale) for v in corpus.val_set])
    wide = val_set.total_voting_power() >= 2**30
    vk = "verify13" if fe_radix == 13 else "verify"
    fk = fused_kernel(fe_radix, wide)
    flow, store, app = _node(corpus, EngineConfig(max_batch=MAX_BATCH, device=str(dev),
                                                  fe_radix=fe_radix), val_set=val_set)
    require(isinstance(flow.verifier, DeviceVoteVerifier) and flow.verifier.fe_radix == fe_radix
            and flow.verifier._stage.wide == wide, "engine is not on the device verifier asked for")
    host_calls, restore_host = _count_host_verifies()
    _lib.reset_launches()
    try:
        run = _drive(flow, dev)
        engine_launches, engine_host = dict(_lib.launches), host_calls["n"]
        more = extra(flow) if extra else {}
    finally:
        restore_host()
    launches = dict(_lib.launches)
    log(f"{label}: {run['steps']} steps, engine launches {engine_launches}, with the rest of the "
        f"path {launches}, host verifies by the engine {engine_host}")
    # one fused verify + tally launch a served step, in this field and
    # width; no verify alone, no standalone tally
    require_launches(engine_launches, {fk: run["steps"]}, label,
                     none_of=(vk,) + STANDALONE_TALLY)
    other_lib = "verify" if fe_radix == 13 else "verify13"
    other = [k for k, lib in _lib.KERNELS.items() if lib == other_lib] + [
        k for k in _lib.KERNELS if k.startswith("verify") and k.endswith("64") != wide
        and ("_tally" in k or "_partial" in k)] + ["tally" if wide else "tally64"]
    require(all(launches[k] == 0 for k in other), f"a kernel of another field or width ran: {launches}")
    # one timed device step per fused launch: the timing wrapper saw them all
    require(len(run["device_ms_per_step"]) == engine_launches[fk],
            f"{len(run['device_ms_per_step'])} timed device steps for launches {engine_launches}")
    require(engine_host == 0, "a host (scalar) verify ran in the engine")
    # the outcome known by construction, and the certificates against the
    # reference run or, for the first run, a sample against the golden model
    res = _outcome(corpus, flow, store, app, scale)
    if ref is not None:
        require(res["rows"] == ref["rows"], f"{label}: certificate bytes differ from the reference run")
        require(res["digest"] == ref["digest"], f"{label}: app digest differs from the reference run")
    else:
        certs = [flow.load_commit(h) for h in res["rows"]]
        pick = random.Random(SEED).sample(certs, min(64, len(certs)))
        pub_of = {v.address: v.pub_key for v in corpus.val_set}
        for cert in pick:
            for cs in cert.commits:
                require(host_ed.verify_pure(pub_of[cs.validator_address],
                                            canonical_sign_bytes(CHAIN_ID, cs.height, cs.tx_hash,
                                                                 cs.timestamp_ns),
                                            cs.signature), "certificate vote fails verify_pure")
    n_votes = len(corpus.votes)
    out = {"votes": n_votes, "txs": len(corpus.txs), "validators": corpus.n_vals,
           "quorum": val_set.quorum_power(), "fe_radix": fe_radix, "int64_tally": wide,
           "total_power": val_set.total_voting_power(), **run,
           "committed_txs": res["committed_txs"], "committed_votes": res["committed_votes"],
           "committed_votes_per_s": res["committed_votes"] / run["wall_s"],
           "votes_per_s": n_votes / run["wall_s"], "equal_to_reference_run": ref is not None,
           "launches": launches, "engine_launches": engine_launches, "host_verifies": engine_host,
           "sign_s": corpus.sign_s, **more}
    log(f"{label}: time by stage over the run (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in run["stage_ms_total"].items())
        + "; device time per step (CUDA events around the verify + tally launches) "
        + ", ".join(f"{d:.2f}" for d in run["device_ms_per_step"])
        + f" ms = {out['device_busy_share'] * 100:.2f}% of the step time")
    log(f"{label}: {out['committed_txs']}/{out['txs']} txs committed as constructed"
        + (", certificate bytes and app digest equal to the reference run" if ref else "")
        + f", {out['committed_votes']} certificate votes; {out['committed_votes_per_s']:.0f} committed "
        f"votes/s, {out['votes_per_s']:.0f} votes/s, p50 step {out['p50_step_ms']:.1f} ms over "
        f"{run['steps']} steps")
    return out, res


def _count_host_verifies() -> tuple[dict, object]:
    """Wrap the host verifiers to count their calls (a run of the device
    path makes none). Returns (counts, restore)."""
    calls = {"n": 0}
    originals = (host_ed.verify, host_ed.verify_pure)

    def counting(fn):
        def wrapped(*a, **k):
            calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    host_ed.verify, host_ed.verify_pure = counting(originals[0]), counting(originals[1])

    def restore():
        host_ed.verify, host_ed.verify_pure = originals

    return calls, restore


def _pair_ms(pairs) -> float:
    """The slowest card's milliseconds between its pair of events."""
    for _, e1 in pairs:
        e1.synchronize()
    return max(e0.elapsed_time(e1) for e0, e1 in pairs)


def _time_stages(flow, dev, by_thread: dict | None = None, route_ends: list | None = None,
                 events: list | None = None) -> tuple[dict, list]:
    """Wrap the engine's stage methods on this instance to add up host
    seconds per stage (drain + sign bytes; host prep + H2D + launch;
    readback wait; routing; commit effects, inline or on the committer
    thread), and record CUDA events around the device step of each step:
    the fused verify + tally kernels, or on a mesh the whole sharded step
    (the H2D copies of its shards included), read on every card of the
    mesh and the slowest card kept; each collect reads the oldest pair
    (tickets are collected in submission order). With ``by_thread`` the
    seconds are also added up per thread (stages on two threads overlap:
    their sum is no serial time), and ``route_ends`` gets the host clock
    at the end of each routing. ``events`` (the FIFO of event pairs not
    yet read) lets a caller read a pair that no collect reads, such as
    the warm step's."""
    stages = {"drain": 0.0, "submit": 0.0, "collect": 0.0, "route": 0.0, "commit": 0.0}
    device_ms: list[float] = []
    events = [] if events is None else events
    mesh = getattr(flow.verifier, "mesh", None)
    cards = list(dict.fromkeys(mesh.devices)) if mesh is not None else [dev]

    def timed(stage, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t1 = time.perf_counter()
                stages[stage] += t1 - t
                if by_thread is not None:
                    mine = by_thread.setdefault(threading.current_thread().name,
                                                dict.fromkeys(stages, 0.0))
                    mine[stage] += t1 - t
                if stage == "route" and route_ends is not None:
                    route_ends.append(t1)
        return wrapped

    def with_events(fn):
        def device_step(*a, **k):
            if dev.type != "cuda":
                return fn(*a, **k)
            pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                     for _ in cards]
            for (e0, _), c in zip(pairs, cards):
                e0.record(torch.cuda.current_stream(c))
            out = fn(*a, **k)
            for (_, e1), c in zip(pairs, cards):
                e1.record(torch.cuda.current_stream(c))
            events.append((threading.current_thread().name, pairs))
            return out
        return device_step

    def collect(prep, ticket, _fn=timed("collect", flow._collect)):
        res = _fn(prep, ticket)
        # the oldest pair recorded on this thread: tickets are collected
        # in submission order by the thread that submitted them
        me = threading.current_thread().name
        i = next((i for i, (who, _) in enumerate(events) if who == me), None)
        if i is not None:
            device_ms.append(_pair_ms(events.pop(i)[1]))
        return res

    if mesh is not None:
        flow.verifier._step = with_events(flow.verifier._step)
    else:  # the verifier calls it through the module
        tally.compact_step_packed = with_events(tally.compact_step_packed)
    flow._prep_batch = timed("drain", flow._prep_batch)
    flow._submit_prep = timed("submit", flow._submit_prep)
    flow._collect = collect
    flow._route_result = timed("route", flow._route_result)
    flow._commit_effects = timed("commit", flow._commit_effects)
    flow._commit_batch = timed("commit", flow._commit_batch)
    return stages, device_ms


# ---------------------------------------------------------------------------
# Phase 8: the threaded engine -- TxFlow.start()/stop() serving through the
# pipelined loop, the committer thread, process-pool host prep and the
# readback ring on a side CUDA stream


def _cold_copies(votes: list) -> list:
    """New vote objects: cold sign-bytes and wire caches, as the first
    serial run of a corpus sees them."""
    return [TxVote(v.height, v.tx_hash, v.tx_key, v.timestamp_ns, v.validator_address,
                   v.signature) for v in votes]


def _wait_quiescent(flow, timeout: float) -> float:
    """Poll until the engine has visited every pool entry and holds no
    retry, no unrouted batch and no unapplied commit, three polls in a
    row; returns the host clock of the first of them. A failed engine
    thread raises here."""
    deadline = time.perf_counter() + timeout
    first, stable = None, 0
    while time.perf_counter() < deadline:
        require(flow.error is None, f"an engine thread failed: {flow.error!r}")
        # cheap reads: this thread shares the interpreter lock with the
        # engine's; both lanes' cursors and retry lists
        pool = flow.tx_vote_pool
        idle = (flow._drain_cursor >= pool.seq() and flow._prio_drain_cursor >= pool.prio_seq()
                and not flow._retry and not flow._retry_prio
                and flow._pipe_in_flight == 0 and flow.commits_drained())
        now = time.perf_counter()
        if not idle:
            first, stable = None, 0
        else:
            first = now if first is None else first
            stable += 1
            if stable >= 3:
                return first
        time.sleep(0.005)
    raise AssertionError("the threaded engine never drained")


def threaded_phase(corpus: Corpus, dev, ref: dict, serial: dict, label: str, mesh=None,
                   engine_builds_mesh: bool = False, max_batch: int = MAX_BATCH,
                   max_slots: int = 4096, pipeline_commits: bool = True) -> dict:
    """The corpus' votes (cold copies) through TxFlow.start() / stop():
    pipeline_depth 2, the committer thread, host prep on a process pool of
    os.cpu_count() workers, readback through the ring (depth 2). On a mesh
    (4 shards; the engine builds it from mesh_devices when
    ``engine_builds_mesh``) each ticket has one part per shard. Checks:
    the committed set, certificate rows and app digest equal ``ref`` (the
    serial engine's), every ticket read back on the side streams, every
    kernel of the path launched, no host verify, and stop() leaving no
    thread, worker process, segment or ring. ``serial`` is the serial
    run of the same cell in this call, printed beside. With
    ``pipeline_commits`` False the routing commits inline (no committer
    thread): the diagnostic run that shows what the committer costs. The
    engine runs without the coalescer and the priority lane (the lanes
    phase drives those), as this phase was first measured."""
    workers = os.cpu_count() or 1
    cfg = EngineConfig(max_batch=max_batch, max_slots=max_slots, device=str(dev), fe_radix=25,
                       mesh_devices=MESH_SHARDS if mesh is not None else 0,
                       pipeline_depth=2, pipeline_commits=pipeline_commits, staging_ring=2,
                       host_prep_backend="process", host_prep_workers=workers,
                       coalesce=False, lane_split=False)
    verifier = (DeviceVoteVerifier(corpus.val_set, mesh=mesh, fe_radix=25, staging_ring=2)
                if mesh is not None and not engine_builds_mesh else None)
    flow, store, app = _node(corpus, cfg, verifier, votes=_cold_copies(corpus.votes))
    if mesh is not None:
        require(flow.verifier.mesh is not None and flow.verifier.mesh.devices == mesh.devices,
                f"{label}: engine is not on the mesh")
    by_thread: dict = {}
    route_ends: list = []
    events: list = []
    tally_step = tally.compact_step_packed
    _, device_ms = _time_stages(flow, dev, by_thread, route_ends, events)
    cpu_s: dict = {}  # CPU seconds of each engine thread (time.thread_time)

    def on_cpu_clock(name, fn):
        def run():
            c0 = time.thread_time()
            try:
                fn()
            finally:
                cpu_s[name] = time.thread_time() - c0
        return run

    flow._run = on_cpu_clock("txflow", flow._run)
    flow._committer_run = on_cpu_clock("txflow-commit", flow._committer_run)
    host_calls, restore_host = _count_host_verifies()
    _lib.reset_launches()
    try:
        with GcClock() as gcc:
            t_start = time.perf_counter()
            flow.start()
            t0 = time.perf_counter()
            ring, pool = flow.verifier._ring, flow._host_pool
            t_end = _wait_quiescent(flow, timeout=300.0)
        stats = flow.pipeline_stats()
        ring_stats, pool_stats = ring.stats(), pool.stats()
    finally:
        restore_host()
        tally.compact_step_packed = tally_step
        flow.stop()  # raises a thread's error
    launches = dict(_lib.launches)
    steps = stats["steps"]
    shards = MESH_SHARDS if mesh is not None else 1
    log(f"{label}: {steps} steps + the warm step, {workers} host-prep workers "
        f"(os.cpu_count(), {pool_stats['processes']} processes, {pool_stats['mp_method']}), "
        f"launches {launches}, host verifies {host_calls['n']}; ring {ring_stats}")
    # one fused launch a shard a step and for the warm step; on the mesh
    # one reduce a step; no verify alone, no standalone tally
    if mesh is None:
        want = {fused_kernel(): steps + 1}
    else:
        want = {fused_kernel(partial=True): shards * (steps + 1), "reduce_quorum": steps + 1}
    require_launches(launches, want, label, none_of=("verify", "verify_tally" if mesh else
                                                     "verify_partial") + STANDALONE_TALLY)
    require(host_calls["n"] == 0, f"{label}: a host (scalar) verify ran")
    require(ring_stats["stream_readbacks"] == steps + 1 and ring_stats["sync_readbacks"] == 0
            and ring_stats["host_readbacks"] == 0 and ring_stats["in_flight"] == 0,
            f"{label}: a readback missed the side stream: {ring_stats}")
    require(pool_stats["backend"] == "process" and pool_stats["shm_calls"] >= steps,
            f"{label}: host prep did not run on the process pool: {pool_stats}")
    require(pool.alive_workers() == 0 and pool.stats()["live_segments"] == 0
            and flow._thread is None and flow._committer is None
            and flow.verifier.staging_stats() is None,
            f"{label}: stop() left a worker, segment, thread or ring behind")
    require(len(device_ms) == steps, f"{label}: {len(device_ms)} timed device steps for {steps}")
    warm_pairs = [pairs for who, pairs in events if who == threading.current_thread().name]
    require(len(warm_pairs) == 1 and len(events) == 1, f"{label}: {len(events)} untimed steps")
    warm_device_ms = _pair_ms(warm_pairs[0]) if warm_pairs else None
    res = _outcome(corpus, flow, store, app)
    require(res["rows"] == ref["rows"], f"{label}: certificate bytes differ from the serial engine")
    require(res["digest"] == ref["digest"], f"{label}: app digest differs from the serial engine")

    wall = t_end - t0
    step_s = [b - a for a, b in zip([t0] + route_ends[:-1], route_ends)]
    threads = {name: {k: v * 1e3 for k, v in st.items()} for name, st in by_thread.items()}
    busy_s = {name: sum(st.values()) for name, st in by_thread.items()}
    out = {"votes": len(corpus.votes), "txs": len(corpus.txs), "validators": corpus.n_vals,
           "shards": shards, "devices": [str(d) for d in (mesh.devices if mesh else [dev])],
           "host_prep_workers": workers, "pipeline_depth": 2, "staging_ring": 2,
           "start_s": t0 - t_start, "warm_s": flow.warm_s, "warm_device_ms": warm_device_ms,
           "steps": steps, "wall_s": wall, "step_s": step_s,
           "first_step_ms": step_s[0] * 1e3 if step_s else None,
           "later_steps_ms": [x * 1e3 for x in step_s[1:]],
           "device_ms_per_step": device_ms, "device_busy_share": sum(device_ms) / (wall * 1e3),
           "committed_txs": res["committed_txs"], "committed_votes": res["committed_votes"],
           "committed_votes_per_s": res["committed_votes"] / wall,
           "serial_committed_votes_per_s": serial["committed_votes_per_s"],
           "serial_wall_s": serial["wall_s"],
           "speedup_over_serial": serial["wall_s"] / wall,
           "stage_ms_by_thread": threads, "busy_s_by_thread": busy_s,
           "cpu_s_by_thread": cpu_s, "pipeline_commits": pipeline_commits,
           "gc_s_with_start": gcc.s, "gc_collections": gcc.collections,
           "prep_pool_wait_s": stats["prep_pool_wait_s"], "pool_proc_wait_s": pool_stats["proc_wait_s"],
           "pool": pool_stats, "ring": ring_stats, "hidden_s": ring_stats["hidden_s"],
           "pipeline": {k: v for k, v in stats.items() if k not in ("host_prep", "staging")},
           "launches": launches, "certificates_equal_serial": True, "digest_equal_serial": True}
    log(f"{label}: wall {wall:.3f} s, {out['committed_votes_per_s']:.0f} committed votes/s against "
        f"the serial engine's {serial['committed_votes_per_s']:.0f} in this call "
        f"({out['speedup_over_serial']:.2f}x); start {out['start_s']:.2f} s (warm step "
        f"{flow.warm_s:.3f} s, its device time {warm_device_ms} ms)")
    log(f"{label}: first step {out['first_step_ms']:.1f} ms, then "
        + ", ".join(f"{x:.1f}" for x in out["later_steps_ms"]) + " ms; device ms per step "
        + ", ".join(f"{d:.2f}" for d in device_ms)
        + f" = {out['device_busy_share'] * 100:.2f}% of the wall time")
    log(f"{label}: busy s by thread (wall time inside its stages) "
        + ", ".join(f"{k} {v:.3f}" for k, v in busy_s.items())
        + "; CPU s by thread (from start() to stop()) "
        + ", ".join(f"{k} {v:.3f}" for k, v in cpu_s.items())
        + f"; prep-pool wait {stats['prep_pool_wait_s']:.3f} s (sign bytes), "
        f"{pool_stats['proc_wait_s']:.3f} s (all pool calls); ring hidden_s "
        f"{ring_stats['hidden_s']:.6f} of readback_s {ring_stats['readback_s']:.6f}, "
        f"sync_readbacks {ring_stats['sync_readbacks']}; garbage collector {gcc.s:.3f} s "
        f"(start() included), collections by generation {gcc.collections}")
    log(f"{label}: stage ms by thread {json.dumps(threads)}")
    log(f"{label}: {res['committed_txs']}/{len(corpus.txs)} txs committed as constructed; "
        "certificate bytes and app digest equal to the serial engine's")
    return out


def serial_again(corpus: Corpus, dev, ref: dict, label: str) -> dict:
    """The serial engine once more on cold copies of the corpus' votes,
    after the threaded runs: the same call's second serial reading
    (serial, threaded, serial), its certificates and app digest equal to
    ``ref``."""
    flow, store, app = _node(corpus, EngineConfig(max_batch=MAX_BATCH, device=str(dev),
                                                  fe_radix=25), votes=_cold_copies(corpus.votes))
    run = _drive(flow, dev)
    res = _outcome(corpus, flow, store, app)
    require(res["rows"] == ref["rows"] and res["digest"] == ref["digest"],
            f"{label}: certificates or app digest differ from the first serial run")
    run["committed_votes_per_s"] = res["committed_votes"] / run["wall_s"]
    log(f"{label}: wall {run['wall_s']:.3f} s, {run['committed_votes_per_s']:.0f} committed "
        f"votes/s, p50 step {run['p50_step_ms']:.1f} ms; host stages (ms) "
        + ", ".join(f"{k} {v:.1f}" for k, v in run["stage_ms_total"].items())
        + f"; garbage collector {run['gc_s']:.3f} s {run['gc_collections']}")
    return run


# ---------------------------------------------------------------------------
# Phase 9: the JAX engine's default served path -- the priority and bulk
# lanes fed by the fee classifier, the shape-stable coalescer, speculative
# commit -- as a backlog and under an arrival rate


class StampedKV(KVStoreApplication):
    """The kvstore app, keeping each DeliverTx with the host clock."""

    def __init__(self):
        super().__init__()
        self.delivered: list[tuple[bytes, float]] = []

    def deliver_tx(self, tx):
        res = super().deliver_tx(tx)
        self.delivered.append((tx, time.perf_counter()))
        return res


def _lanes_config(dev, speculative: bool) -> EngineConfig:
    """The JAX engine's defaults, spelled out, over the slice cell's
    widths, with the threaded phase's committer and process host prep."""
    return EngineConfig(max_batch=MAX_BATCH, max_slots=4096, device=str(dev), fe_radix=25,
                        min_batch=256, coalesce=True, coalesce_linger=0.004, lane_split=True,
                        priority_linger=0.001, priority_bucket_cap=512, pipeline_depth=2,
                        pipeline_commits=True, staging_ring=2, host_prep_backend="process",
                        host_prep_workers=os.cpu_count() or 1, speculative_commit=speculative)


def _feed_at_rate(votepool, votes: list, order, rate: float, chunk: int, stamps: dict,
                  out: dict) -> None:
    """Feed ``votes`` in ``order`` to the pool through check_tx_many in
    chunks of ``chunk`` at ``rate`` votes/s; each vote's pool key is stamped
    with the host clock just before its chunk goes in. A failure is kept in
    ``out["error"]``."""
    try:
        t0 = out["t0"] = time.perf_counter()
        rejected = 0
        for base in range(0, len(order), chunk):
            due = t0 + base / rate
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            part = [votes[i] for i in order[base : base + chunk]]
            t = time.perf_counter()
            for v in part:
                stamps[v.vote_key()] = t
            rejected += sum(e is not None for e in votepool.check_tx_many(part))
        out["t_end"] = time.perf_counter()
        out["rejected"] = rejected
    except BaseException as exc:  # raised by the caller
        out["error"] = exc


def _first_vs_rest(values: list) -> dict:
    return {"n": len(values), "first": values[0],
            "rest_median": statistics.median(values[1:]) if len(values) > 1 else None}


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def lanes_serial_ref(corpus: Corpus, dev) -> dict:
    """The serial engine (step(), no lanes wired) on the lanes corpus: the
    outcome known by construction, its certificate rows, delivered txs and
    app state, which every lanes run must reproduce."""
    app = StampedKV()
    flow, store, app = _node(corpus, EngineConfig(max_batch=MAX_BATCH, device=str(dev),
                                                  fe_radix=25), votes=_cold_copies(corpus.votes),
                             app=app)
    run = _drive(flow, dev)
    res = _outcome(corpus, flow, store, app)
    res["delivered"] = sorted(tx for tx, _ in app.delivered)
    res["state"] = dict(app.state)
    log(f"lanes serial reference: {res['committed_txs']}/{len(corpus.txs)} txs committed as "
        f"constructed ({sum(tx.startswith(LANE_FEE) for tx in res['delivered'])} with the fee "
        f"prefix), wall {run['wall_s']:.3f} s over {run['steps']} steps")
    return res


def lanes_run(corpus: Corpus, dev, ref: dict, label: str, rate: float | None = None,
              speculative: bool = False) -> dict:
    """The lanes corpus' votes (cold copies) through TxFlow.start() on the
    default served path: with ``rate`` None every vote is in the pool
    before start() (a backlog); else a feeder thread calls check_tx_many in
    chunks of LANE_CHUNK at ``rate`` votes/s after start(). Checks: the
    committed set, certificate rows and delivered txs equal ``ref`` (the
    serial engine's), the app state equal to its own delivery log folded
    (the fee txs share the kvstore key "fee", so their last value follows
    the commit order, which the lanes change), priority batches, every
    bulk drain a coalescer target or a counted flush, every priority drain
    counted, the fused verify + tally launched once a ticket and once a
    warm step (one at
    each rung up to the drain cap), no host verify, speculative commits when on, and stop() leaving no thread,
    worker, segment or ring. Returns the run's numbers."""
    votes = _cold_copies(corpus.votes)
    flow, store, app = _node(corpus, _lanes_config(dev, speculative), votes=votes, lanes=True,
                             feed=rate is None, app=StampedKV())
    votepool = flow.tx_vote_pool
    by_thread: dict = {}
    route_ends: list = []
    events: list = []
    tally_step = tally.compact_step_packed
    _, device_ms = _time_stages(flow, dev, by_thread, route_ends, events)
    drains: list = []  # (lane, limit) of every drain the loop asked for
    submits: list = []  # (lane, rung, host ms of the submit stage), in order
    prep_batch, submit = flow._prep_batch, flow._submit_prep

    def drain_rec(limit=None, lane=None):
        drains.append((lane, limit))
        return prep_batch(limit, lane)

    live_after_submit: list = []  # the host-prep pool's live segments after each submit

    def submit_rec(prep):
        t = time.perf_counter()
        try:
            return submit(prep)
        finally:
            submits.append((prep.lane, bucket_size(len(prep.votes), flow.verifier.buckets),
                            (time.perf_counter() - t) * 1e3))
            live_after_submit.append(flow._host_pool.stats()["live_segments"])

    flow._prep_batch, flow._submit_prep = drain_rec, submit_rec
    host_calls, restore_host = _count_host_verifies()
    stamps: dict = {}
    feed: dict = {}
    _lib.reset_launches()
    try:
        with GcClock() as gcc:
            t_start = time.perf_counter()
            flow.start()
            t0 = time.perf_counter()
            ring, pool = flow.verifier._ring, flow._host_pool
            if rate is not None:
                feeder = threading.Thread(target=_feed_at_rate, name="feeder", args=(
                    votepool, votes, corpus.order, rate, LANE_CHUNK, stamps, feed))
                feeder.start()
                feeder.join()
                require("error" not in feed, f"{label}: the feeder failed: {feed.get('error')!r}")
                require(feed["rejected"] == 0, f"{label}: the pool rejected {feed['rejected']} votes")
                t0 = feed["t0"]
            t_end = _wait_quiescent(flow, timeout=300.0)
        stats = flow.pipeline_stats()
        ring_stats, pool_stats = ring.stats(), pool.stats()
    finally:
        restore_host()
        tally.compact_step_packed = tally_step
        flow.stop()  # raises a thread's error
    launches = dict(_lib.launches)
    steps = stats["steps"]
    co, lanes, spec = stats["coalesce"], stats["lanes"], stats["spec"]
    log(f"{label}: {steps} steps + warm steps at {flow.warm_rungs}, launches {launches}, host "
        f"verifies {host_calls['n']}; coalescer {co}; lanes {lanes}; spec {spec}")
    # one fused verify + tally launch a ticket and a warm step (one at each
    # rung up to the drain cap); no verify alone, no standalone tally
    warm = len(flow.warm_rungs)
    require(flow.warm_rungs == [MAX_BATCH, 4096, 1024, 256, 64],
            f"{label}: warm steps at {flow.warm_rungs}")
    require_launches(launches, {fused_kernel(): steps + warm}, label,
                     none_of=("verify",) + STANDALONE_TALLY)
    require(len(submits) == steps, f"{label}: {len(submits)} submits for {steps} steps")
    require(host_calls["n"] == 0, f"{label}: a host (scalar) verify ran")
    require(ring_stats["stream_readbacks"] == steps + warm and ring_stats["sync_readbacks"] == 0
            and ring_stats["host_readbacks"] == 0 and ring_stats["in_flight"] == 0,
            f"{label}: a readback missed the side stream: {ring_stats}")
    # a backlog drains full rungs past the pool's gate; under the feed the
    # small batches prep inline, as _POOL_MIN_VOTES means them to
    require(pool_stats["backend"] == "process" and (rate is not None or pool_stats["shm_calls"] > 0),
            f"{label}: host prep never ran on the process pool: {pool_stats}")
    # each pool call unlinks its segments before it returns, so two tickets
    # in flight (a priority and a bulk one) never share one
    require(max(live_after_submit, default=0) == 0,
            f"{label}: a shared-memory segment outlived its submit: {max(live_after_submit)}")
    require(pool.alive_workers() == 0 and pool.stats()["live_segments"] == 0
            and flow._thread is None and flow._committer is None
            and flow.verifier.staging_stats() is None,
            f"{label}: stop() left a worker, segment, thread or ring behind")
    require(len(device_ms) == steps, f"{label}: {len(device_ms)} timed device steps for {steps}")
    require(len(events) == warm, f"{label}: {len(events)} untimed steps, {warm} warm steps")
    # the served path: both lanes, the coalescer on the ladder
    require(co["enabled"] and lanes["enabled"] and lanes["prio_batches"] > 0,
            f"{label}: the coalescer or the priority lane never ran")
    require(co["targets"] == [256, 1024, 4096, 16384] and lanes["prio_targets"] == [64, 256],
            f"{label}: coalescer targets {co['targets']}, priority {lanes['prio_targets']}")
    require(all(lane in ("prio", "bulk") for lane, _ in drains), f"{label}: a merged drain ran")
    bulk = [lim for lane, lim in drains if lane == "bulk"]
    prio = [lim for lane, lim in drains if lane == "prio"]
    n_full = sum(lim in co["targets"] for lim in bulk)
    require(n_full == co["full_batches"] and len(bulk) - n_full == co["linger_flushes"],
            f"{label}: bulk drains {len(bulk)} ({n_full} at a target) against the coalescer's "
            f"{co['full_batches']} full batches and {co['linger_flushes']} flushes")
    require(len(prio) == lanes["prio_full_batches"] + lanes["prio_linger_flushes"],
            f"{label}: {len(prio)} priority drains against the lane's counts")
    require(not speculative or spec["commits"] > 0, f"{label}: no speculative commit")
    require(spec["enabled"] == speculative, f"{label}: spec {spec}")
    res = _outcome(corpus, flow, store, app)
    require(res["rows"] == ref["rows"], f"{label}: certificate bytes differ from the serial engine")
    delivered = [tx for tx, _ in app.delivered]
    require(sorted(delivered) == ref["delivered"], f"{label}: delivered txs differ from serial")
    folded: dict = {}
    for tx in delivered:
        k, v = tx.split(b"=", 1)
        folded[k] = v
    require(app.state == folded, f"{label}: app state != its own delivery log")
    require({k: v for k, v in app.state.items() if k != b"fee"}
            == {k: v for k, v in ref["state"].items() if k != b"fee"},
            f"{label}: app state differs from the serial engine's")

    wall = t_end - t0
    rungs: dict = {}
    for (lane, rung, sub_ms), dms in zip(submits, device_ms):
        r = rungs.setdefault(f"{lane} {rung}", {"submit_ms": [], "device_ms": []})
        r["submit_ms"].append(sub_ms)
        r["device_ms"].append(dms)
    by_rung = {k: {"batches": len(v["submit_ms"]), "submit_ms": _first_vs_rest(v["submit_ms"]),
                   "device_ms": _first_vs_rest(v["device_ms"])} for k, v in sorted(rungs.items())}
    out = {"votes": len(corpus.votes), "txs": len(corpus.txs),
           "fee_txs": sum(tx.startswith(LANE_FEE) for tx in corpus.txs),
           "rate_votes_per_s": rate, "speculative": speculative,
           "start_s": t0 - t_start if rate is None else None, "warm_s": flow.warm_s,
           "warm_rungs": flow.warm_rungs, "steps": steps, "wall_s": wall,
           "committed_txs": res["committed_txs"], "committed_votes": res["committed_votes"],
           "committed_votes_per_s": res["committed_votes"] / wall,
           "device_ms_per_step": device_ms, "device_busy_share": sum(device_ms) / (wall * 1e3),
           "gc_s": gcc.s, "gc_collections": gcc.collections,
           "coalesce": co, "lanes": lanes, "spec": spec, "by_rung": by_rung,
           "launches_by_rung": {k: v["batches"] for k, v in by_rung.items()},
           "prep_pool_wait_s": stats["prep_pool_wait_s"], "pool_shm_calls": pool_stats["shm_calls"],
           "busy_s_by_thread": {n: sum(st.values()) for n, st in by_thread.items()},
           "launches": launches, "certificates_equal_serial": True}
    if rate is not None:
        out["feed_s"] = feed["t_end"] - feed["t0"]
        out["fed_votes_per_s"] = len(votes) / out["feed_s"]
        commit_t = {hashlib.sha256(tx).hexdigest().upper(): t for tx, t in app.delivered}
        lat: dict = {"priority": [], "bulk": []}
        for tx in corpus.txs:
            h = hashlib.sha256(tx).hexdigest().upper()
            if h not in res["rows"]:
                continue
            cert = flow.load_commit(h)
            last = max(stamps[hashlib.sha256(cs.signature).digest()] for cs in cert.commits)
            lat["priority" if tx.startswith(LANE_FEE) else "bulk"].append(
                (commit_t[h] - last) * 1e3)
        out["commit_latency_ms"] = {
            lane: {"n": len(xs), "p50": _pct(xs, 50), "p99": _pct(xs, 99), "max": max(xs)}
            for lane, xs in lat.items()}
    log(f"{label}: wall {wall:.3f} s, {out['committed_votes_per_s']:.0f} committed votes/s"
        + (f" (fed at {out['fed_votes_per_s']:.0f} votes/s over {out['feed_s']:.3f} s)"
           if rate is not None else f"; start {out['start_s']:.2f} s")
        + f"; {steps} steps: coalescer {co['full_batches']} full, {co['linger_flushes']} "
        f"flushes; priority {lanes['prio_batches']} batches, {lanes['prio_votes']} votes "
        f"({lanes['prio_full_batches']} full, {lanes['prio_linger_flushes']} flushes); "
        f"speculative commits {spec['commits']}, saved {spec['saved_s']:.6f} s")
    if rate is not None:
        log(f"{label}: commit latency (DeliverTx minus the feed of the certificate's last vote) "
            + "; ".join(f"{lane} n {v['n']} p50 {v['p50']:.2f} ms p99 {v['p99']:.2f} ms max "
                        f"{v['max']:.2f} ms" for lane, v in out["commit_latency_ms"].items()))
    def first_rest(d):
        rest = "-" if d["rest_median"] is None else f"{d['rest_median']:.3f}"
        return f"{d['first']:.3f}/{rest}"

    log(f"{label}: batches by lane and rung, first step against the median of the rest "
        "(submit stage host ms; device ms): " + "; ".join(
            f"{k}: {v['batches']}, submit {first_rest(v['submit_ms'])}, device "
            f"{first_rest(v['device_ms'])}" for k, v in by_rung.items()))
    log(f"{label}: device {sum(device_ms):.1f} ms over {steps} steps = "
        f"{out['device_busy_share'] * 100:.3f}% of the wall; garbage collector {gcc.s:.3f} s "
        f"{gcc.collections}; busy s by thread " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["busy_s_by_thread"].items()))
    log(f"{label}: {res['committed_txs']}/{len(corpus.txs)} txs committed as constructed; "
        "certificate bytes, delivered txs and app state equal to the serial engine's")
    return out


def lanes_phase(dev) -> dict:
    """The lanes corpus, the serial reference, then the three runs on cold
    vote copies: backlog, rate, rate + speculative."""
    t0 = time.perf_counter()
    corpus = Corpus(SEED, fee_every=LANE_FEE_EVERY)
    log(f"lanes corpus: {len(corpus.votes)} votes signed in {corpus.sign_s:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with setup); "
        f"{sum(tx.startswith(LANE_FEE) for tx in corpus.txs)} txs with the fee prefix")
    ref = lanes_serial_ref(corpus, dev)
    runs = {"backlog": lanes_run(corpus, dev, ref, "lanes backlog"),
            "rate": lanes_run(corpus, dev, ref, "lanes rate", rate=LANE_RATE),
            "rate_speculative": lanes_run(corpus, dev, ref, "lanes rate + speculative",
                                          rate=LANE_RATE, speculative=True)}
    rungs: dict = {}
    for run in runs.values():
        for k, n in run["launches_by_rung"].items():
            rung = int(k.split()[1])
            rungs[rung] = rungs.get(rung, 0) + n
    return {"sign_s": corpus.sign_s, "runs": runs, "k3_launches_by_rung": rungs}


def k3_rung_rows(card: dict, k3: dict, dev, launches_by_rung: dict) -> list[dict]:
    """K3 at each rung the lanes phase dispatched: ``rung`` rows of the K3
    batch (from row 60, past its rows made to fail the host pre-checks,
    where the batch is long enough), held against the plain version and
    timed (many launches in one CUDA-event window) with its bound;
    ``launches`` is the count of K3 launches at that rung in the lanes
    phase's three runs."""
    rows = []
    per_row = [k3["args"][i] for i in (0, 1, 2, 5, 6, 7)]
    tables, quarters = k3["args"][3], k3["args"][4]
    for rung in sorted(launches_by_rung):
        off = max(0, min(60, per_row[0].shape[0] - rung))
        s_n, h_n, v_i, r_y, r_s, ok = (t[off : off + rung] for t in per_row)
        args = (s_n, h_n, v_i, tables, quarters, r_y, r_s, ok)
        got = ed25519_batch.verify_kernel_gather(*args)
        want = ed25519_batch.verify_kernel_gather_plain(*args)
        torch.cuda.synchronize()
        require(bool((got == want).all()), f"K3 at rung {rung} != plain")
        ms = cuda_ms_window(lambda: ed25519_batch.verify_kernel_gather(*args),
                            50 if rung <= 4096 else 10)
        pms = cuda_ms(lambda: ed25519_batch.verify_kernel_gather_plain(*args), 1)
        n_ok = int(ok.sum())
        r_bytes = nbytes(*args) + nbytes(curve.device_base_quarters(dev, 25)) + rung * 4
        bnd, by = bound_ms(card, r_bytes, n_ok * ed25519_batch.mads_per_signature(25))
        bnd_sq = bound_ms(card, r_bytes, n_ok * ed25519_batch.mads_per_signature(25, sq_as_mul=True))[0]
        rows.append(dict(name=f"K3 ed25519 verify at rung {rung} (txf_verify, lanes phase)",
                         route="cuda", source="txflow_tpu_torch/csrc/verify.cu",
                         replaces="txflow_tpu/ops/ed25519_batch.py:384",
                         launches=launches_by_rung[rung],
                         max_abs_err=int((got.int() - want.int()).abs().max()), ms=ms,
                         plain_ms=pms, bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq,
                         library_ms=None, **VERIFY_LAUNCH_NOTE,
                         shape=f"{rung} rows, {n_ok} past the host pre-checks"))
        log(f"K3 at rung {rung}: bit-exact; {ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.5f} ms "
            f"by {by} [{bnd_sq:.5f}]); {launches_by_rung[rung]} launches in the lanes phase")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: committee certificates (K6) -- the committee-mode fast path with
# an epoch rotation, and a lagging follower's batched certificate re-check


class CommitteeCorpus:
    """COM_VALS validators at power 10; the committees of vote heights 0 and
    1 (COM_SIZE members each, quorum 214 = 22 votes); COM_TXS txs per
    height, every committee member voting on each, about 1/8 of the votes
    byzantine (a flipped R or S byte, or a wrong-chain signature), spread
    so that some txs stay below quorum; arrival shuffled within a height."""

    def __init__(self, seed: int):
        rng = np.random.default_rng(seed)
        seeds = [rng.bytes(32) for _ in range(COM_VALS)]
        pubs = [host_ed.public_key_from_seed(s) for s in seeds]
        self.full = ValidatorSet([Validator.from_pub_key(p, 10) for p in pubs])
        seed_of = {Validator.from_pub_key(p, 1).address: s for p, s in zip(pubs, seeds)}
        self.cfg = EpochConfig(length=1, committee_size=COM_SIZE)
        sched = CommitteeSchedule(COM_CHAIN, self.cfg)
        self.committees = [sched.for_vote_height(h, self.full) for h in (0, 1)]
        self.txs = [b"ctx%05d=%d" % (i, i) for i in range(2 * COM_TXS)]
        # byzantine votes per tx (of 32): mean 3.9, and 11 or 12 (below
        # quorum) on 15% of the txs
        n_byz = rng.choice(np.array([0, 2, 3, 4, 6, 11, 12]) * COM_SIZE // 32, size=len(self.txs),
                           p=[0.2, 0.2, 0.2, 0.15, 0.1, 0.1, 0.05])
        self.votes: list[TxVote] = []
        self.byzantine: list[bool] = []
        self.height: list[int] = []
        items, kinds = [], []
        for t, tx in enumerate(self.txs):
            h = t // COM_TXS
            com = self.committees[h]
            key = hashlib.sha256(tx).digest()
            byz = set(rng.choice(COM_SIZE, size=int(n_byz[t]), replace=False).tolist())
            for m, val in enumerate(com):
                vote = TxVote(h, key.hex().upper(), key, 1_700_000_000_000_000_000 + t, val.address)
                kind = ("flip_r", "flip_s", "wrong_chain")[int(rng.integers(3))] if m in byz else "honest"
                chain = "incorrect-chain-id" if kind == "wrong_chain" else COM_CHAIN
                items.append((seed_of[val.address], vote.sign_bytes(chain)))
                kinds.append(kind)
                self.votes.append(vote)
                self.byzantine.append(m in byz)
                self.height.append(h)
        t0 = time.perf_counter()
        sigs = _sign_all(items)
        self.sign_s = time.perf_counter() - t0
        for vote, sig, kind in zip(self.votes, sigs, kinds):
            if kind == "flip_r":
                sig = sig[:7] + bytes([sig[7] ^ 0x10]) + sig[8:]
            elif kind == "flip_s":
                sig = sig[:45] + bytes([sig[45] ^ 0x01]) + sig[46:]
            vote.signature = sig
        honest = np.zeros(len(self.txs), np.int64)
        for i, b in enumerate(self.byzantine):
            if not b:
                honest[i // COM_SIZE] += 10
        self.quorum = self.committees[0].quorum_power()
        self.expect_commit = honest >= self.quorum
        per_h = COM_TXS * COM_SIZE
        self.orders = [h * per_h + rng.permutation(per_h) for h in (0, 1)]


def _k6_timer(dev):
    """Wrap ed25519_batch.verify_kernel_gather (BatchCertVerifier calls it
    through the module) to record each call's rung, a pair of CUDA events
    around that one launch (so the window holds the launch path too), its
    inputs (the field among them) and its output, under a label the caller
    sets. Returns (records, label, restore)."""
    records: list = []
    label = {"phase": ""}
    fn = ed25519_batch.verify_kernel_gather

    def timed(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **k)
        e1.record()
        records.append((label["phase"], a[0].shape[0], e0, e1, (a, k), out))
        return out

    ed25519_batch.verify_kernel_gather = timed

    def restore():
        ed25519_batch.verify_kernel_gather = fn

    return records, label, restore


def k6_rows(card: dict, com: "CommitteeCorpus", dev, fe_radix: int = 25,
            rungs=K6_RUNGS) -> list[dict]:
    """K6 (txf_verify launched alone over one committee's unpadded tables,
    V = COM_SIZE; over K8 with ``fe_radix`` 13, library verify13) at each
    rung, on height-1 votes of the corpus (their byzantine share
    included): bit-exact against the plain version, against the golden
    model on a sample, and timed over many launches."""
    c1 = com.committees[1]
    epoch = ed25519_batch.EpochTables([v.pub_key for v in c1], fe_radix=fe_radix)
    tables, quarters = epoch.device_tables(dev), epoch.device_quarter_tables(dev)
    require(tables.shape[0] == COM_SIZE, "K6 tables are padded")
    idx = {v.address: i for i, v in enumerate(c1)}
    pubs = [v.pub_key for v in c1]
    rows = []
    for rung in rungs:
        pick = com.orders[1][:rung]
        votes = [com.votes[i] for i in pick]
        msgs = [canonical_sign_bytes(COM_CHAIN, v.height, v.tx_hash, v.timestamp_ns) for v in votes]
        sigs = [v.signature for v in votes]
        vix = np.array([idx[v.validator_address] for v in votes])
        batch = ed25519_batch.prepare_compact(msgs, sigs, vix, epoch)
        require(_rung(len(votes)) == rung, "rung")

        def T(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        args = (T(batch.s_nibbles), T(batch.h_nibbles), T(batch.val_idx), tables, quarters,
                T(batch.r_y), T(batch.r_sign), T(batch.pre_ok))
        k6 = ed25519_batch.verify_kernel_gather(*args, fe_radix=fe_radix)
        p6 = ed25519_batch.verify_kernel_gather_plain(*args, fe_radix=fe_radix)
        torch.cuda.synchronize()
        require(bool((k6 == p6).all()), f"K6 kernel != plain at rung {rung}")
        k6h = k6.cpu().numpy()
        want_byz = np.array([com.byzantine[i] for i in pick])
        require(bool((k6h == ~want_byz).all()), f"K6 at rung {rung} != the corpus' honesty")
        for j in range(0, rung, max(1, rung // 16)):
            require(bool(k6h[j]) == host_ed.verify_pure(pubs[vix[j]], msgs[j], sigs[j]),
                    f"K6 row {j} at rung {rung} != verify_pure")
        n_ok = int(batch.pre_ok.sum())
        ms = cuda_ms_window(lambda: ed25519_batch.verify_kernel_gather(*args, fe_radix=fe_radix),
                            max(10, min(200, 65536 // rung)))
        pms = cuda_ms(lambda: ed25519_batch.verify_kernel_gather_plain(*args, fe_radix=fe_radix), 2)
        r_bytes = nbytes(*args) + nbytes(curve.device_base_quarters(dev, fe_radix)) + rung * 4
        bnd, by = bound_ms(card, r_bytes, n_ok * ed25519_batch.mads_per_signature(fe_radix))
        bnd_sq = bound_ms(card, r_bytes, n_ok * ed25519_batch.mads_per_signature(fe_radix, sq_as_mul=True))[0]
        ab = None
        if rung == 8:  # the A/B in turns (K6, K5, K5, K6): quarter lanes against coordinate lanes
            k5_args = (args[0], args[1], tables[args[2].long()].contiguous(), *args[5:])
            k5 = ed25519_batch.verify_kernel(*k5_args, fe_radix=fe_radix)
            require(bool((k5 == k6).all()), "K5 != K6 at rung 8")
            t = [cuda_ms_window(
                (lambda: ed25519_batch.verify_kernel_gather(*args, fe_radix=fe_radix)) if k == "k6"
                else (lambda: ed25519_batch.verify_kernel(*k5_args, fe_radix=fe_radix)), 200)
                for k in ("k6", "k5", "k5", "k6")]
            ab = {"rows": rung, "k6_quarter_lanes_ms": [t[0], t[3]], "k5_coord_lanes_ms": [t[1], t[2]],
                  "k5_over_k6": (t[1] + t[2]) / (t[0] + t[3])}
            log(f"A/B K6 (quarter lanes) vs K5 (coordinate lanes){' radix 13' if fe_radix == 13 else ''} at "
                f"{rung} rows, in turns: " + json.dumps(ab))
        name = (f"K6 certificate verify (txf_verify alone), rung {rung}" if fe_radix == 25 else
                f"K6 over K8: certificate verify (txf_verify of verify13 alone), rung {rung}")
        rows.append(dict(name=name, route="cuda", fe_radix=fe_radix,
                         source="txflow_tpu_torch/csrc/verify.cu" + (
                             " (-DTXF_FE_RADIX=13), txflow_tpu_torch/csrc/fe25519_13.cuh"
                             if fe_radix == 13 else ""),
                         replaces="txflow_tpu/committee/certverify.py:43",
                         max_abs_err=int((k6.int() - p6.int()).abs().max()), ms=ms, plain_ms=pms,
                         bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None, rung=rung,
                         **VERIFY_LAUNCH_NOTE,
                         shape=f"{rung} rows, {n_ok} past the host pre-checks, V={COM_SIZE}",
                         **({"ab_k5_coord_lanes": ab} if ab else {})))
        log(f"K6{' radix 13' if fe_radix == 13 else ''} rung {rung}: bit-exact ({int(k6h.sum())} valid of {rung}); {ms:.4f} ms "
            f"(plain {pms:.1f} ms, bound {bnd:.5f} ms by {by} [{bnd_sq:.5f}])")
    return rows


def committee_phase(com: "CommitteeCorpus", dev) -> dict:
    """The committee-mode fast path on the card: a serving TxFlow mounting
    BatchCertVerifier drains the height-0 votes, rotates to the epoch-1
    committee (update_state) and drains the height-1 votes; then a follower
    with its own stores walks the server's commit log through the sync wire
    format, refusing three tampered responses and applying the rest after a
    K6 re-check of every certificate."""
    c0, c1 = com.committees
    full = com.full
    require(c0.size() == c1.size() == COM_SIZE and c0.hash() != c1.hash(), "committees")
    need = -(-c0.quorum_power() // 10)  # votes a certificate holds: 22 of 32 (214 of 320)
    n_votes = len(com.votes)

    def node(vals, height):
        conns = AppConns(KVStoreApplication())
        mempool = Mempool(MempoolConfig(size=4 * COM_TXS, cache_size=8 * COM_TXS), conns.mempool)
        commitpool = Mempool(MempoolConfig(size=4 * COM_TXS, cache_size=8 * COM_TXS))
        votepool = TxVotePool(MempoolConfig(size=2 * n_votes, cache_size=2 * n_votes))
        store = TxStore(MemDB())
        verifier = BatchCertVerifier(vals, device=dev, fe_radix=25)
        flow = TxFlow(COM_CHAIN, height, vals, votepool, mempool, commitpool,
                      TxExecutor(conns.consensus, mempool), store,
                      config=EngineConfig(max_batch=MAX_BATCH, device=str(dev), fe_radix=25),
                      verifier=verifier)
        state = StateStore(MemDB())
        for h in (0, 1):  # the full set on record, as the block history holds it
            state.save_validators(h, full)
        return flow, mempool, votepool, store, state, conns.app

    flow, mempool, votepool, store, s_state, app = node(c0, 0)
    require(not any(mempool.check_tx_many(com.txs)), "mempool rejected a tx")
    require(not any(votepool.check_tx_many([com.votes[i] for i in com.orders[0]])),
            "vote pool rejected a vote")
    f_flow, _fm, _fv, f_store, f_state, f_app = node(c1, 1)
    # a second follower re-verifies the same log over the radix-2^13 field
    # (K6 over K8, library verify13)
    g_flow, _gm, _gv, g_store, g_state, g_app = node(c1, 1)
    mgr13 = SyncManager(COM_CHAIN, g_store, g_flow, state_store=g_state,
                        config=SyncConfig(max_range=256, max_resp_bytes=512 * 1024),
                        committee=CommitteeSchedule(COM_CHAIN, com.cfg), device=dev, fe_radix=13)
    mgr = SyncManager(COM_CHAIN, f_store, f_flow, state_store=f_state,
                      config=SyncConfig(max_range=256, max_resp_bytes=512 * 1024),
                      committee=CommitteeSchedule(COM_CHAIN, com.cfg), device=dev, fe_radix=25)

    records, label, restore = _k6_timer(dev)
    restage_s = [0.0]
    restage = flow.verifier.restage

    def timed_restage(vals):  # the table build + upload part of the rotation
        t = time.perf_counter()
        try:
            return restage(vals)
        finally:
            restage_s[0] += time.perf_counter() - t

    flow.verifier.restage = timed_restage
    tally_step = tally.compact_step_packed
    stages, _ = _time_stages(flow, dev)  # host seconds by engine stage
    step_s: list[float] = []
    host_calls, restore_host = _count_host_verifies()
    _lib.reset_launches()
    try:
        # the serving engine: height 0, rotation, height 1
        label["phase"] = "step"
        wall = 0.0
        for h in (0, 1):
            if h == 1:
                t0 = time.perf_counter()
                flow.update_state(1, c1)
                rot_s = time.perf_counter() - t0
                require(not any(votepool.check_tx_many([com.votes[i] for i in com.orders[1]])),
                        "vote pool rejected a vote")
            t0 = time.perf_counter()
            while True:
                ts = time.perf_counter()
                if not flow.step():
                    break
                step_s.append(time.perf_counter() - ts)
            wall += time.perf_counter() - t0
        rotation = dict(flow.last_rotation)
        # the follower: three tampered copies of the first response, then
        # the honest walk over the server's log
        label["phase"] = "tampered"
        cfg = mgr.config
        advert, entries, snaps = serve_range(store, cfg, 0, cfg.max_range, s_state.load_validators)
        tampered = {}
        for case, want in (("flipped signature byte", "invalid signature"),
                           ("duplicated vote", "invalid signature"),
                           (f"certificate cut to {need - 1} votes", "below 2/3+ stake")):
            bad = list(entries)
            tx_hash, cert, tx = bad[5]
            votes = _decode_votes(cert)
            if case.startswith("flipped"):
                sig = votes[3].signature
                votes[3].signature = sig[:9] + bytes([sig[9] ^ 0x04]) + sig[10:]
            elif case.startswith("duplicated"):
                votes.append(votes[0])
            else:
                votes = votes[: need - 1]
            bad[5] = (tx_hash, _encode_votes(votes), tx)
            frame = wire.encode_range_resp(0, 0, advert, bad, snaps)
            try:
                mgr.apply_range_resp("server", frame)
                raise AssertionError(f"tampered response ({case}) was applied")
            except SyncError as e:
                require(e.byzantine and want in str(e), f"{case}: {e!r}")
                tampered[case] = str(e)
            require(f_store.seq_count() == 0, f"{case}: something was applied")
        label["phase"] = "sync"
        apply_s = [0.0]
        apply_fn = f_flow.apply_synced_commit

        def timed_apply(*a, **k):
            t = time.perf_counter()
            try:
                return apply_fn(*a, **k)
            finally:
                apply_s[0] += time.perf_counter() - t

        f_flow.apply_synced_commit = timed_apply
        responses, n_entries, heights_per_resp = 0, 0, []
        t0 = time.perf_counter()
        start = 0
        while start < store.seq_count():
            body = serve_range(store, cfg, start, cfg.max_range, s_state.load_validators)
            frame = wire.encode_range_resp(responses, start, *body)
            got, served, applied = mgr.apply_range_resp("server", frame)
            require(got == start and served == applied > 0, "a response applied short")
            heights_per_resp.append(sorted(body[2]))
            responses += 1
            n_entries += served
            start += served
        sync_s = time.perf_counter() - t0
        label["phase"] = "sync13"
        t0 = time.perf_counter()
        start, k = 0, 0
        while start < store.seq_count():
            body = serve_range(store, cfg, start, cfg.max_range, s_state.load_validators)
            got, served, applied = mgr13.apply_range_resp(
                "server", wire.encode_range_resp(k, start, *body))
            require(got == start and served == applied > 0, "a radix-13 response applied short")
            start += served
            k += 1
        sync13_s = time.perf_counter() - t0
    finally:
        restore_host()
        tally.compact_step_packed = tally_step
        restore()
    launches = dict(_lib.launches)
    torch.cuda.synchronize()
    by_phase: dict[str, list] = {"step": [], "tampered": [], "sync": [], "sync13": []}
    rungs: dict[str, dict] = {"step": {}, "tampered": {}, "sync": {}, "sync13": {}}
    for ph, rung, e0, e1, _a, _o in records:
        by_phase[ph].append(e0.elapsed_time(e1))
        rungs[ph][rung] = rungs[ph].get(rung, 0) + 1
    # K6 against its plain version on the main path's own launches: the
    # first launch of every (phase, rung, staged tables) -- the steps'
    # rung 16384 over each committee's V = 32 tables, the sync groups'
    # rungs -- rerun through the plain version on the recorded inputs
    checked, seen = [], set()
    for ph, rung, _e0, _e1, (args, kw), out in records:
        key = (ph, rung, args[3].data_ptr())
        if key in seen:
            continue
        seen.add(key)
        plain = ed25519_batch.verify_kernel_gather_plain(*args, **kw)
        require(bool((out == plain).all()), f"K6 != plain on the {ph} launch at rung {rung}")
        require(kw.get("fe_radix") == (13 if ph == "sync13" else 25), f"K6 {ph} launch on the wrong field")
        checked.append({"phase": ph, "rung": rung, "V": args[3].shape[0], "fe_radix": kw["fe_radix"],
                        "valid": int(out.sum()), "max_abs_err": int((out.int() - plain.int()).abs().max())})
    require({(c["phase"], c["rung"]) for c in checked}
            == {(ph, r) for ph in rungs for r in rungs[ph]}, "a main-path K6 shape went unchecked")
    log(f"committee: K6 bit-exact with its plain version on {len(checked)} main-path launches "
        f"(each phase, rung and committee's tables): {checked}")
    f_verifiers = (list(mgr._verifiers.values()) + [f_flow.verifier]
                   + list(mgr13._verifiers.values()) + [g_flow.verifier])
    batch_calls = flow.verifier.batch_calls + sum(v.batch_calls for v in f_verifiers)
    scalar_calls = flow.verifier.scalar_calls + sum(v.scalar_calls for v in f_verifiers)
    log(f"committee: {len(step_s)} steps, {responses} responses, launches {launches}, "
        f"K6 calls by phase and rung {rungs}, host verifies {host_calls['n']}")
    require(launches["verify"] + launches["verify13"] == batch_calls == len(records) > 0,
            "K6 launches != batch calls")
    require(launches["verify13"] == len(by_phase["sync13"]) > 0, "K6 over K8 launches != radix-13 groups")
    require(launches["tally"] == launches["fe_ops"] == launches["dsm_encode"] == 0, "other kernels ran")
    require(scalar_calls == 0 and host_calls["n"] == 0, "a host (scalar) verify ran")
    require(len(by_phase["step"]) == len(step_s), "one K6 launch per step")

    # the rotation
    require(rotation["restaged"] is True and rotation["commits_on_rotation"] == 0, f"{rotation}")
    c1_addrs = {v.address for v in c1}
    dropped = sum(1 for i in range(COM_TXS * COM_SIZE)
                  if not com.expect_commit[i // COM_SIZE] and not com.byzantine[i]
                  and com.votes[i].validator_address not in c1_addrs)
    require(rotation["votes_dropped"] == dropped, f"votes_dropped {rotation['votes_dropped']} != {dropped}")
    require(flow.verifier.val_set.hash() == c1.hash(), "verifier not restaged")

    # the server's outcome, known by construction
    hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in com.txs]
    committed = np.array([flow.is_tx_committed(h) for h in hashes])
    require(bool((committed == com.expect_commit).all()),
            f"committed {int(committed.sum())} txs, expected {int(com.expect_commit.sum())}")
    require(0 < committed.sum() < len(com.txs), "the byzantine spread left no tx below quorum")
    byz = {(v.tx_hash, v.validator_address): b for v, b in zip(com.votes, com.byzantine)}
    committed_votes = 0
    for t, h in enumerate(hashes):
        if not committed[t]:
            continue
        cert = flow.load_commit(h)
        ch = t // COM_TXS
        require(all(cs.height == ch for cs in cert.commits), "certificate mixes heights")
        require(all(com.committees[ch].has_address(cs.validator_address) for cs in cert.commits),
                "certificate vote from outside its epoch's committee")
        require(not any(byz[(h, cs.validator_address)] for cs in cert.commits),
                "a byzantine vote in a certificate")
        require(len(cert.commits) == need, f"certificate of {len(cert.commits)} votes")
        committed_votes += len(cert.commits)
    want_keys = {tx.split(b"=")[0] for tx, c in zip(com.txs, committed) if c}
    require(set(app.state) == want_keys and app.tx_count == len(want_keys), "server app state")

    # the follower equals the server
    order = store.committed_hashes_in_order()
    require(f_store.committed_hashes_in_order() == order, "follower commit order != server's")
    require(all(f_store.load_cert_row(h) == store.load_cert_row(h) for h in order),
            "a follower certificate row differs from the server's")
    require(f_app.state == app.state and f_app.digest == app.digest, "follower app state != server's")
    require(n_entries == len(order), "entries served != commits")
    require(g_store.committed_hashes_in_order() == order
            and all(g_store.load_cert_row(h) == store.load_cert_row(h) for h in order)
            and g_app.state == app.state and g_app.digest == app.digest,
            "the radix-13 follower != the server")

    p50 = statistics.median(step_s)
    sync_verify_ms = sum(by_phase["sync"])
    stage_ms = {k: v * 1e3 for k, v in stages.items()}
    stage_ms["route"] -= stage_ms["commit"]  # commits run inside routing
    out = {"validators": COM_VALS, "committee_size": COM_SIZE, "quorum": c0.quorum_power(),
           "votes": n_votes, "txs": len(com.txs), "steps": len(step_s), "step_s": step_s,
           "p50_step_ms": p50 * 1e3, "wall_s": wall,
           "k6_one_launch_window_ms_per_step": by_phase["step"],
           "committed_txs": int(committed.sum()), "committed_votes": committed_votes,
           "committed_votes_per_s": committed_votes / wall, "votes_per_s": n_votes / wall,
           "stage_ms_total": stage_ms,
           "rotation": rotation, "rotation_s": rot_s, "rotation_restage_s": restage_s[0],
           "responses": responses, "entries": n_entries, "groups": len(by_phase["sync"]),
           "vote_heights_per_response": heights_per_resp,
           "k6_launches": launches["verify"], "k6_calls_by_phase_and_rung": rungs,
           "k6_main_path_checked": checked,
           "tampered": tampered, "sync_s": sync_s,
           "sync_k6_one_launch_window_ms_total": sync_verify_ms,
           "k6_one_launch_window_ms_per_group": by_phase["sync"], "sync_apply_s": apply_s[0],
           "sync_host_verify_s": sync_s - apply_s[0] - sync_verify_ms / 1e3,
           "sync13_s": sync13_s, "k6_13_launches": launches["verify13"],
           "sync13_k6_one_launch_window_ms_total": sum(by_phase["sync13"]),
           "host_verifies": host_calls["n"], "sign_s": com.sign_s}
    log(f"committee: {out['committed_txs']}/{len(com.txs)} txs committed as constructed, "
        f"{committed_votes} certificate votes; {out['committed_votes_per_s']:.0f} committed votes/s, "
        f"p50 step {out['p50_step_ms']:.1f} ms over {len(step_s)} steps; K6 one-launch window per step "
        + ", ".join(f"{d:.2f}" for d in by_phase["step"])
        + f" ms; rotation in {rot_s * 1e3:.1f} ms ({restage_s[0] * 1e3:.1f} ms restaging): {rotation}")
    log("committee: server time by stage over the run (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items()))
    log(f"committee: follower applied {n_entries} certificates from {responses} responses "
        f"({len(by_phase['sync'])} K6 launches) in {sync_s:.2f} s: K6 one-launch windows {sync_verify_ms:.1f} ms, "
        f"apply {apply_s[0]:.2f} s; tampered responses refused: {tampered}")
    log(f"committee: the radix-13 follower re-verified the same log ({len(by_phase['sync13'])} K6 "
        f"launches over K8, one-launch windows {sum(by_phase['sync13']):.1f} ms) in {sync13_s:.2f} s, "
        f"ending equal to the server")
    return out


# ---------------------------------------------------------------------------
# Phase 5: the mesh-sharded serving step (K5 and K7) -- BASELINE config 4


def round_robin_mesh(n: int) -> Mesh:
    """n shards over the visible cards in turn: on one card, n shards on
    it (the counterpart of the JAX tests' virtual devices; a harness
    choice -- the engine's make_mesh only ever takes distinct cards)."""
    cards = torch.cuda.device_count()
    return Mesh(tuple(torch.device("cuda", i % cards) for i in range(n)))


def _first_batch(corpus: Corpus, n: int, epoch):
    """The first ``n`` votes in arrival order as a compact batch over
    ``epoch``, with their slots (the engine's first drain)."""
    order = corpus.order[:n]
    votes = [corpus.votes[i] for i in order]
    msgs = [canonical_sign_bytes(CHAIN_ID, v.height, v.tx_hash, v.timestamp_ns) for v in votes]
    sigs = [v.signature for v in votes]
    vix = np.array([corpus.val_set.index_of(v.validator_address) for v in votes])
    slot_of: dict[str, int] = {}
    slots = np.array([slot_of.setdefault(v.tx_hash, len(slot_of)) for v in votes], np.int32)
    return msgs, sigs, vix, slots, ed25519_batch.prepare_compact(msgs, sigs, vix, epoch)


class FirstBatch:
    """The first MESH_BATCH votes in arrival order (the first sharded
    step's drain), on the host: K3's compact prep, K5's per-vote tables,
    slots, each vote's power, and the construction's verdicts."""

    def __init__(self, corpus: Corpus, n: int):
        self.epoch = epoch = ed25519_batch.EpochTables([v.pub_key for v in corpus.val_set],
                                                       fe_radix=25)
        self.msgs, self.sigs, self.vix, self.slots, self.compact = _first_batch(corpus, n, epoch)
        self.n_slots = int(self.slots.max()) + 1
        self.byz = np.array([corpus.byzantine[i] for i in corpus.order[:n]])
        self.power = np.asarray(corpus.powers, np.int32)[self.vix]
        self.tables = ed25519_batch.prepare_batch(self.msgs, self.sigs, self.vix, epoch)
        # what a verify and a tally of these votes must give
        self.want_valid = ~self.byz
        self.want_stake = np.zeros(MESH_SLOTS, np.int64)
        np.add.at(self.want_stake, self.slots, np.where(self.byz, 0, self.power))

    def compact_args(self):
        c = self.compact
        return [torch.from_numpy(np.ascontiguousarray(x)) for x in (
            c.s_nibbles, c.h_nibbles, c.val_idx, c.r_y, c.r_sign, c.pre_ok, self.slots)]

    def table_args(self, rows=slice(None)):
        t = self.tables
        return tuple(torch.from_numpy(np.ascontiguousarray(x[rows])) for x in (
            t.s_nibbles, t.h_nibbles, t.a_tables, t.r_y, t.r_sign, t.pre_ok))


def mesh_phase(corpus: Corpus, mesh: Mesh, engine_builds_mesh: bool) -> tuple[dict, FirstBatch,
                                                                                dict]:
    """The mesh-sharded serving step, then the same votes on one card.

    The mesh path, between one reset and one read of the launch counts:
    TxFlow.step() with EngineConfig(max_batch=MESH_BATCH, max_slots=
    MESH_SLOTS, mesh_devices=MESH_SHARDS) -- the engine builds its mesh of
    distinct cards when ``engine_builds_mesh``, else it mounts a
    DeviceVoteVerifier over ``mesh`` -- then, on the first step's votes,
    the K5 entry points (sharded_verify_and_tally over the mesh, and
    verify_batch on one shard's worth) and the ring step. Each of those is
    checked against the construction. Then the one-card engine at
    max_batch MESH_BATCH: certificate bytes and app digest must equal the
    mesh run's. Returns (the phase's numbers, the first batch, the one-card
    engine's outcome)."""
    dev0 = mesh.devices[0]
    cfg = EngineConfig(max_batch=MESH_BATCH, max_slots=MESH_SLOTS, mesh_devices=MESH_SHARDS,
                       fe_radix=25)
    verifier = (None if engine_builds_mesh
                else DeviceVoteVerifier(corpus.val_set, mesh=mesh, fe_radix=25))
    flow, store, app = _node(corpus, cfg, verifier)
    require(flow.verifier.mesh is not None and flow.verifier.mesh.size == MESH_SHARDS,
            "engine is not on the mesh")
    if engine_builds_mesh:
        require(flow.verifier.mesh.devices == mesh.devices, "engine mesh != make_mesh(4)")
    t0 = time.perf_counter()
    fb = FirstBatch(corpus, MESH_BATCH)
    epoch = fb.epoch
    prep_s = time.perf_counter() - t0
    host_calls, restore_host = _count_host_verifies()
    quorum = corpus.quorum
    _lib.reset_launches()
    try:
        run = _drive(flow, dev0)
        engine_launches = dict(_lib.launches)
        # the K5 entry points and the ring step, on the first step's votes
        prior0 = torch.zeros(MESH_SLOTS, dtype=torch.int32)
        svt = sharded_verify_and_tally(mesh, fe_radix=25)(
            fb.table_args(), torch.from_numpy(fb.slots), torch.from_numpy(fb.power), prior0, quorum)
        vb = ed25519_batch.verify_batch(
            ed25519_batch.PreparedBatch(*(x[:MESH_BATCH // MESH_SHARDS] for x in (
                fb.tables.s_nibbles, fb.tables.h_nibbles, fb.tables.a_tables, fb.tables.r_y,
                fb.tables.r_sign, fb.tables.pre_ok))), device=dev0)
        tables_r = mesh.replicate(epoch.device_tables(dev0))
        quarters_r = mesh.replicate(epoch.device_quarter_tables(dev0))
        powers_r = mesh.replicate(torch.tensor(corpus.powers, dtype=torch.int32))
        ring = sharded_ring_step(mesh, fe_radix=25)(*fb.compact_args(), tables_r, quarters_r,
                                                    powers_r, prior0, quorum)
        for d in dict.fromkeys(mesh.devices):
            torch.cuda.synchronize(d)
    finally:
        restore_host()
    launches = dict(_lib.launches)
    steps = run["steps"]
    log(f"mesh: {steps} sharded steps over {[str(d) for d in mesh.devices]}, engine launches "
        f"{engine_launches}; with the K5 entry points and the ring step {launches}; "
        f"host verifies {host_calls['n']}")
    # a sharded step: one fused verify + partial launch a shard, one reduce
    per_step = {"verify_partial": MESH_SHARDS * steps, "reduce_quorum": steps}
    require_launches(engine_launches, per_step, "mesh engine",
                     none_of=("verify", "verify_tally", "verify_tables", "ring_add")
                     + STANDALONE_TALLY)
    require(len(run["device_ms_per_step"]) == steps, "a sharded step went untimed")
    # then sharded_verify_and_tally (K5 + standalone partials, one
    # reduce), verify_batch (K5) and the ring step (fused partials, the
    # ring's hops, a reduce a shard)
    require_launches(launches, {
        "verify_tables": MESH_SHARDS + 1, "ring_add": MESH_SHARDS * (MESH_SHARDS - 1),
        "verify_partial": per_step["verify_partial"] + MESH_SHARDS, "tally_partial": MESH_SHARDS,
        "reduce_quorum": steps + 1 + MESH_SHARDS}, "mesh path with K5 and the ring",
        none_of=("verify", "verify_tally", "tally", "tally64", "tally_partial64"))
    require(host_calls["n"] == 0, "a host (scalar) verify ran")
    # the K5 and ring results against the construction
    want_stake = torch.from_numpy(fb.want_stake.astype(np.int32))
    want_maj = want_stake >= quorum
    require(bool((to_host(svt[0]).numpy() == fb.want_valid).all()), "sharded K5 valid != construction")
    require(bool((vb == fb.want_valid[: len(vb)]).all()), "verify_batch != construction")
    require(bool((to_host(ring[0]).numpy() == fb.want_valid).all()), "ring step valid != construction")
    for sh in range(MESH_SHARDS):
        for name, (st, mj) in (("sharded_verify_and_tally", (svt[1][sh], svt[2][sh])),
                               ("ring step", (ring[1][sh], ring[2][sh]))):
            require(bool((st.cpu() == want_stake).all() and (mj.cpu() == want_maj).all()),
                    f"{name}: shard {sh}'s tally != construction")
    mesh_out = _outcome(corpus, flow, store, app)

    # the same votes through the one-card engine
    flow1, store1, app1 = _node(corpus, EngineConfig(
        max_batch=MESH_BATCH, max_slots=MESH_SLOTS, device=str(dev0), fe_radix=25))
    require(flow1.verifier.mesh is None, "one-card engine on a mesh")
    _lib.reset_launches()
    run1 = _drive(flow1, dev0)
    launches1 = dict(_lib.launches)
    require(run1["steps"] > 0, "the one-card engine ran no step")
    require_launches(launches1, {fused_kernel(): run1["steps"]}, "one-card engine",
                     none_of=("verify", "verify_partial", "reduce_quorum") + STANDALONE_TALLY)
    one_out = _outcome(corpus, flow1, store1, app1)
    require(one_out["rows"] == mesh_out["rows"], "certificate bytes differ between mesh and one card")
    require(one_out["digest"] == mesh_out["digest"], "app digest differs between mesh and one card")
    out = {"validators": corpus.n_vals, "txs": len(corpus.txs), "votes": len(corpus.votes),
           "quorum": quorum, "shards": MESH_SHARDS, "devices": [str(d) for d in mesh.devices],
           "engine_built_mesh": engine_builds_mesh, "first_batch_prep_s": prep_s,
           "launches": launches, "engine_launches": engine_launches, "one_card_launches": launches1,
           "committed_txs": mesh_out["committed_txs"], "committed_votes": mesh_out["committed_votes"],
           "certificates_equal_one_card": True, "digest_equal_one_card": True,
           "host_verifies": host_calls["n"], "sign_s": corpus.sign_s}
    for name, r, o in (("mesh", run, mesh_out), ("one_card", run1, one_out)):
        r["committed_votes_per_s"] = o["committed_votes"] / r["wall_s"]
        out[name] = r
        log(f"mesh phase, {name}: {r['steps']} steps, p50 step {r['p50_step_ms']:.1f} ms, "
            f"{r['committed_votes_per_s']:.0f} committed votes/s; host stages (ms) "
            + ", ".join(f"{k} {v:.1f}" for k, v in r["stage_ms_total"].items())
            + "; device ms per step " + ", ".join(f"{d:.2f}" for d in r["device_ms_per_step"])
            + f" = {r['device_busy_share'] * 100:.2f}% of the step time")
    log(f"mesh: {mesh_out['committed_txs']}/{len(corpus.txs)} txs committed as constructed, "
        f"{mesh_out['committed_votes']} certificate votes; certificate bytes and app digest "
        f"equal to the one-card run's")
    return out, fb, one_out


def count_step_ops(step, *args, **kwargs):
    """One call of a sharded step: (its output, {"launches": kernel
    launches by name, "copies": the psum's tensor copies (peer copies of
    partials and copies of the reduced tail, ``parallel.mesh.copies``)})."""
    before, copies0 = dict(_lib.launches), sum(mesh_mod.copies.values())
    out = step(*args, **kwargs)
    return out, {"launches": {k: v - before[k] for k, v in _lib.launches.items() if v != before[k]},
                 "copies": sum(mesh_mod.copies.values()) - copies0}


def launch_path_split(acc, b, reps: int = 2000) -> dict:
    """Host microseconds a call of each piece of the ring hop's launch path
    takes, each piece alone in a loop of ``reps`` calls between two host
    clock reads (the card synchronised before and after): the one-pass
    check of both tensors, the current-device read, the stream read, the
    two data_ptr reads, the ctypes call of txf_add (which launches the
    kernel), the whole ring_add, the allocation the hop no longer makes
    (torch.empty_like), and the whole torch.add. What ring_add spends
    beyond the sum of its pieces is the launcher lookup, the argument
    tuple and the count."""
    idx, s = acc.device.index, acc.shape[0]
    cfn = _lib.library("tally").txf_add
    stream = torch.cuda.current_stream(idx).cuda_stream
    pa, pb = acc.data_ptr(), b.data_ptr()
    pieces = {
        "check_all": lambda: _lib.check_all((acc, torch.int32, (s,), "acc"), (b, torch.int32, (s,), "b")),
        "current_device": torch.cuda.current_device,
        "stream_read": lambda: torch.cuda.current_stream(idx).cuda_stream,
        "data_ptrs": lambda: (acc.data_ptr(), b.data_ptr()),
        "ctypes_call_and_launch": lambda: cfn(pa, pb, s, stream),
        "ring_add_whole": lambda: tally.ring_add(acc, b),
        "empty_like_allocation": lambda: torch.empty_like(acc),
        "torch_add_whole": lambda: torch.add(acc, b),
    }
    out = {}
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) / reps * 1e6
    return out


def mesh_rows(card: dict, corpus: Corpus, mesh: Mesh, fb: FirstBatch, launches: dict,
              steps: int) -> list[dict]:
    """K5 and the K7 kernels at the per-shard shapes the mesh path
    launches, each bit-exact against its plain version on the card and
    timed over many launches in one CUDA-event window; and the whole
    sharded step against the plain verify + tally of the full batch."""
    rows = []
    dev0 = mesh.devices[0]
    bs, S, n = MESH_BATCH // MESH_SHARDS, MESH_SLOTS, MESH_SHARDS
    rng = np.random.default_rng(SEED + 5)

    def on0(ts):
        return [t.to(dev0) for t in ts]

    # K5 on shard 0's rows
    k5_args = on0(fb.table_args(slice(0, bs)))
    k5 = ed25519_batch.verify_kernel(*k5_args)
    p5 = ed25519_batch.verify_kernel_plain(*k5_args)
    torch.cuda.synchronize(dev0)
    require(bool((k5 == p5).all()), "K5 kernel != plain")
    require(bool((k5.cpu().numpy() == fb.want_valid[:bs]).all()), "K5 != construction")
    n_ok = int(fb.tables.pre_ok[:bs].sum())
    ms = cuda_ms_window(lambda: ed25519_batch.verify_kernel(*k5_args), 10)
    pms = cuda_ms(lambda: ed25519_batch.verify_kernel_plain(*k5_args), 2)
    k5_bytes = nbytes(*k5_args, curve.device_base_quarters(dev0)[0]) + bs * 4
    bnd, by = bound_ms(card, k5_bytes, n_ok * ed25519_batch.mads_per_signature(25, four_lanes=False))
    bnd_sq = bound_ms(card, k5_bytes, n_ok * ed25519_batch.mads_per_signature(25, four_lanes=False,
                                                                              sq_as_mul=True))[0]
    rows.append(dict(name="K5 ed25519 verify over per-vote tables (txf_verify_tables, four lanes a row by "
                          "coordinate)", route="cuda",
                     source="txflow_tpu_torch/csrc/verify.cu",
                     replaces="txflow_tpu/ops/ed25519_batch.py:146", launches=launches["verify_tables"],
                     max_abs_err=int((k5.int() - p5.int()).abs().max()), ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None,
                     shape=f"{bs} rows (one shard), {n_ok} past the host pre-checks", **COORD_NOTE))
    log(f"K5 verify_tables: bit-exact over {bs} rows; {ms:.3f} ms (plain {pms:.1f} ms, "
        f"bound {bnd:.4f} ms by {by} [{bnd_sq:.4f}])")

    # K7 partial tally of each shard (K3's valid, per-validator powers)
    c = fb.compact
    powers = torch.tensor(corpus.powers, dtype=torch.int32, device=dev0)
    valid = torch.from_numpy(fb.want_valid.astype(np.int32)).to(dev0)
    slot = torch.from_numpy(fb.slots).to(dev0)
    vidx = torch.from_numpy(np.ascontiguousarray(c.val_idx)).to(dev0)
    parts, plains = [], []
    for sh in range(n):
        r = slice(sh * bs, (sh + 1) * bs)
        parts.append(tally.tally_partial(valid[r], slot[r], vidx[r], powers, S))
        plains.append(tally.tally_partial_plain(valid[r], slot[r], vidx[r], powers, S))
    torch.cuda.synchronize(dev0)
    require(all(bool((a == b).all()) for a, b in zip(parts, plains)), "K7 partial tally != plain")
    v0, s0, i0 = valid[:bs], slot[:bs], vidx[:bs]
    ms = cuda_ms_window(lambda: tally.tally_partial(v0, s0, i0, powers, S), 500, warmup=5)
    pms = cuda_ms(lambda: tally.tally_partial_plain(v0, s0, i0, powers, S), 20, warmup=2)
    slot_c, in_range = s0.long().clamp(0, S - 1), (s0 >= 0) & (s0 < S)
    zeros = torch.zeros(S, dtype=torch.int32, device=dev0)

    def library_partial():  # power gather, the mask and index_add
        return zeros.index_add(0, slot_c, torch.where((v0 > 0) & in_range, powers[i0.long()], 0))

    require(bool((library_partial() == parts[0]).all()), "index_add partial != kernel")
    lib_ms = cuda_ms_window(library_partial, 500, warmup=5)
    bnd, by = bound_ms(card, nbytes(v0, s0, i0, powers) + S * 4, bs)
    rows.append(dict(name="K7 per-shard partial tally, standalone (txf_tally_partial; "
                          "sharded_verify_and_tally's)", route="cuda",
                     source="txflow_tpu_torch/csrc/tally.cu", replaces="txflow_tpu/parallel/mesh.py:114",
                     launches=launches["tally_partial"],
                     max_abs_err=int(max((a - b).abs().max() for a, b in zip(parts, plains))),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                     shape=f"{bs} votes, {S} slots",
                     **small_kernel_split(lambda: tally.tally_partial(v0, s0, i0, powers, S))))
    log(f"K7 partial: bit-exact on {n} shards; {ms:.4f} ms (plain {pms:.3f}, index_add {lib_ms:.4f}, "
        f"bound {bnd:.6f} ms by {by})")

    # K7 reduce-quorum: the n partials and a prior that takes about half
    # the slots over quorum (the first step alone holds a quarter of the votes)
    q = corpus.quorum
    prior = torch.from_numpy(rng.integers(q // 2, q, S).astype(np.int32)).to(dev0)
    stacked = torch.stack(parts)
    quorum = corpus.quorum
    st, mj = tally.reduce_quorum(stacked, prior, quorum)
    pst, pmj = tally.reduce_quorum_plain(stacked, prior, quorum)
    torch.cuda.synchronize(dev0)
    require(bool((st == pst).all() and (mj == pmj).all()), "K7 reduce-quorum != plain")
    require(bool(((st.cpu() - prior.cpu()) == torch.from_numpy(fb.want_stake.astype(np.int32))).all()),
            "K7 reduce of the partials != construction")
    require(0 < int(mj.sum()) < S, "reduce case too weak")
    ms = cuda_ms_window(lambda: tally.reduce_quorum(stacked, prior, quorum), 500, warmup=5)
    pms = cuda_ms(lambda: tally.reduce_quorum_plain(stacked, prior, quorum), 20, warmup=2)

    def library_reduce():  # one PyTorch reduction + the prior + the compare
        total = torch.stack(parts).sum(0) + prior
        return total, total >= quorum

    lt, lm = library_reduce()
    require(bool((lt == st).all() and (lm.int() == mj).all()), "torch reduction != kernel")
    lib_ms = cuda_ms_window(library_reduce, 500, warmup=5)
    bnd, by = bound_ms(card, nbytes(stacked, prior) + 2 * S * 4, (n + 1) * S)
    # launches_per_mesh_step and per_step_ms come from the sharded step's call below
    reduce_row = dict(name="K7 psum: partials + prior >= quorum (txf_reduce_quorum)", route="cuda",
                      source="txflow_tpu_torch/csrc/tally.cu", replaces="txflow_tpu/ops/tally.py:101",
                      launches=launches["reduce_quorum"],
                      max_abs_err=int(max((st - pst).abs().max(), (mj - pmj).abs().max())),
                      ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                      shape=f"{n} partials x {S} slots", library_per_step_ms=lib_ms,
                      **small_kernel_split(lambda: tally.reduce_quorum(stacked, prior, quorum)))
    rows.append(reduce_row)
    log(f"K7 reduce-quorum: bit-exact; {ms:.4f} ms (plain {pms:.3f}, torch.stack().sum(0) + prior "
        f"and compare {lib_ms:.4f}, bound {bnd:.6f} ms by {by})")

    # K7 ring hop: in place into a buffer the hop owns
    a, b = parts[0], parts[1]
    acc = a.clone()
    k = tally.ring_add(acc, b)
    want_k = tally.ring_add_plain(a.clone(), b)
    require(k is acc and bool((k == want_k).all()), "K7 ring add != plain")
    err = int((k - (a + b)).abs().max())
    # in turns (hop, torch.add, torch.add, hop), each 500 launches in one window
    hop = lambda: tally.ring_add(acc, b)  # noqa: E731
    add = lambda: torch.add(a, b)  # noqa: E731
    t = [cuda_ms_window(fn, 500, warmup=5) for fn in (hop, add, add, hop)]
    ms, lib_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    pms = cuda_ms(lambda: tally.ring_add_plain(a.clone(), b), 20, warmup=2)
    bnd, by = bound_ms(card, 3 * S * 4, S)
    split = launch_path_split(acc, b)
    rows.append(dict(name="K7 ring hop accumulate, in place (txf_add)", route="cuda",
                     source="txflow_tpu_torch/csrc/tally.cu", replaces="txflow_tpu/parallel/mesh.py:130",
                     launches=launches["ring_add"], max_abs_err=err,
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                     **small_kernel_split(hop),
                     in_turns_ms={"ring_add": [t[0], t[3]], "torch_add": [t[1], t[2]]},
                     launch_path_us=split, shape=f"{S} slots"))
    log(f"K7 ring add: bit-exact; {ms:.4f} ms (in turns {t[0]:.4f}, {t[3]:.4f}; torch.add "
        f"{t[1]:.4f}, {t[2]:.4f}; plain {pms:.4f}, bound {bnd:.6f} ms by {by}); host launch path "
        "(us a call): " + json.dumps(split))

    # the whole sharded step on inputs already on their cards
    epoch = fb.epoch
    args = fb.compact_args()
    shards = [mesh.shard(x) for x in args]
    consts = [mesh.replicate(epoch.device_tables(dev0)), mesh.replicate(epoch.device_quarter_tables(dev0)),
              mesh.replicate(powers), prior]
    step = sharded_compact_step_packed(mesh, fe_radix=25)
    packed_k, ops = count_step_ops(step, *shards, *consts, quorum)
    got = to_host(packed_k)
    require(ops["launches"] == {"verify_partial": n, "reduce_quorum": 1}
            and ops["copies"] <= 2 * (n - 1),
            f"a sharded step made {ops}: want {n} fused launches, 1 reduce, <= {2 * (n - 1)} copies")
    per_step = ops["launches"]["reduce_quorum"]
    reduce_row.update(launches_per_mesh_step=per_step, per_step_ms=per_step * reduce_row["ms"])
    full = on0(args)
    pv = ed25519_batch.verify_kernel_gather_plain(*full[:3], consts[0][0], consts[1][0], *full[3:6])
    pst, pmj = tally.tally_plain(pv, full[6], full[2], powers, prior, quorum)
    want = torch.cat([torch.cat([pv[sh * bs:(sh + 1) * bs].int(), pst, pmj]) for sh in range(n)]).cpu()
    require(bool((got == want).all()), "K7 sharded step != plain verify + tally")
    cards = list(dict.fromkeys(mesh.devices))
    ms = cuda_ms_window(lambda: step(*shards, *consts, quorum), 5, devices=cards)
    t0 = time.perf_counter()
    ed25519_batch.verify_kernel_gather_plain(*full[:3], consts[0][0], consts[1][0], *full[3:6])
    tally.tally_plain(pv, full[6], full[2], powers, prior, quorum)
    torch.cuda.synchronize(dev0)
    pms = (time.perf_counter() - t0) * 1e3
    n_ok = int(c.pre_ok.sum())
    k_cards = len(cards)
    scaled = dict(card, hbm_bytes_per_s=card["hbm_bytes_per_s"] * k_cards,
                  imad_per_s=card["imad_per_s"] * k_cards)
    s_bytes = nbytes(*args) + nbytes(consts[0][0], consts[1][0], powers, prior) + n * (bs + 2 * S) * 4
    bnd, by = bound_ms(scaled, s_bytes, n_ok * ed25519_batch.mads_per_signature(25))
    bnd_sq = bound_ms(scaled, s_bytes, n_ok * ed25519_batch.mads_per_signature(25, sq_as_mul=True))[0]
    rows.append(dict(name="K7 sharded fused step (per shard txf_verify_tally's partial form, "
                          "peer copies, one txf_reduce_quorum)", route="cuda",
                     launches_per_step=ops["launches"], copies_per_step=ops["copies"],
                     ctypes_calls_per_step=sum(ops["launches"].values()),
                     source="txflow_tpu_torch/parallel/mesh.py", replaces="txflow_tpu/parallel/mesh.py:114",
                     launches=steps, max_abs_err=int((got - want).abs().max()), ms=ms, plain_ms=pms,
                     bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None, cards=k_cards,
                     shape=f"{MESH_BATCH} rows = {n} shards x {bs} on {k_cards} card(s), {S} slots",
                     time_note="window over 5 steps, events on every card, slowest card; "
                               "plain: one host-clock run"))
    log(f"K7 sharded step: bit-exact over {MESH_BATCH} rows on {k_cards} card(s); {ms:.3f} ms "
        f"(plain {pms:.1f} ms, bound {bnd:.4f} ms by {by} [{bnd_sq:.4f}])")
    return rows


# ---------------------------------------------------------------------------
# Phase 6: the radix-2^13 field (K8) through verify, committee and mesh, and
# the int64 stake tally of sets of total power >= 2^30


def ptxas_info() -> dict:
    """Registers, stack and spill bytes of every kernel of each library,
    from the build's ``-Xptxas -v`` output."""
    import re

    def kernel_of(fn):  # the kernel's name, and its accumulator type for a template
        k = re.search(r"(txf_\w+?_kernel)(I[il]E)?", fn or "")
        return k and k.group(1) + {"IiE": "<int32>", "IlE": "<int64>"}.get(k.group(2), "")

    info = {}
    for name in _lib.LIBS:
        kernels, fn, spills = {}, None, [0, 0]
        for ln in (_lib.BUILD / f"lib{name}.build.txt").read_text().splitlines():
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and fn:
                spills[0] += int(m.group(2))
                spills[1] += int(m.group(3))
                if kernel_of(fn):
                    kernels.setdefault(kernel_of(fn), {}).update(
                        stack_bytes=int(m.group(1)), spill_bytes=int(m.group(2)) + int(m.group(3)))
                continue
            m = re.search(r"Used (\d+) registers", ln)
            if m and kernel_of(fn):
                kernels.setdefault(kernel_of(fn), {})["registers"] = int(m.group(1))
        info[name] = {"kernels": kernels, "spill_store_bytes": spills[0], "spill_load_bytes": spills[1]}
    return info


def radix13_mesh_reference(corpus: Corpus, mesh: Mesh) -> dict:
    """The radix-2^25.5 sharded step over the round-robin mesh on the
    first MAX_BATCH votes (nonzero prior): the packed output the radix-13
    step must equal. Runs before the radix-13 path's launch window."""
    pubs = [v.pub_key for v in corpus.val_set]
    epochs = {r: ed25519_batch.EpochTables(pubs, fe_radix=r) for r in (25, 13)}
    msgs, sigs, vix, slots, c = _first_batch(corpus, MAX_BATCH, epochs[25])
    rng = np.random.default_rng(SEED + 13)
    prior = np.zeros(N_TXS, np.int32)
    prior[: int(slots.max()) + 1] = rng.integers(0, 200, int(slots.max()) + 1)
    T = torch.from_numpy
    vote = [T(np.ascontiguousarray(x)) for x in (c.s_nibbles, c.h_nibbles, c.val_idx, c.r_y,
                                                  c.r_sign, c.pre_ok, slots)]
    powers = torch.tensor(corpus.powers, dtype=torch.int32)
    dev0 = mesh.devices[0]
    packed = to_host(sharded_compact_step_packed(mesh, fe_radix=25)(
        *vote, mesh.replicate(epochs[25].device_tables(dev0)),
        mesh.replicate(epochs[25].device_quarter_tables(dev0)), powers, T(prior), corpus.quorum))
    return dict(msgs=msgs, sigs=sigs, vix=vix, slots=slots, vote=vote, powers=powers,
                prior=T(prior), epochs=epochs, packed=packed)


def radix13_mesh_path(corpus: Corpus, mesh: Mesh, ref: dict) -> dict:
    """On the radix-13 path: one sharded step over the round-robin mesh
    (4 x txf_verify of verify13, partial tallies, the psum), equal to the
    radix-25 step's packed output; then the K5 entry point over the same
    votes (sharded_verify_and_tally, txf_verify_tables of verify13),
    equal to the step's valid and stake."""
    dev0 = mesh.devices[0]
    e13 = ref["epochs"][13]
    c13 = ed25519_batch.prepare_compact(ref["msgs"], ref["sigs"], ref["vix"], e13)
    vote = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        c13.s_nibbles, c13.h_nibbles, c13.val_idx, c13.r_y, c13.r_sign, c13.pre_ok)] + [ref["vote"][6]]
    for a, b in zip(vote, ref["vote"]):
        require(bool((a == b).all()), "the radix-13 prep differs from the radix-25 prep")
    got = to_host(sharded_compact_step_packed(mesh, fe_radix=13)(
        *vote, mesh.replicate(e13.device_tables(dev0)), mesh.replicate(e13.device_quarter_tables(dev0)),
        ref["powers"], ref["prior"], corpus.quorum))
    require(bool((got == ref["packed"]).all()), "radix-13 sharded step != radix-25 packed output")
    pb = ed25519_batch.prepare_batch(ref["msgs"], ref["sigs"], ref["vix"], e13)
    per_vote = ref["powers"][torch.from_numpy(ref["vix"].astype(np.int64))]
    svt = sharded_verify_and_tally(mesh, fe_radix=13)(
        [torch.from_numpy(np.ascontiguousarray(x)) for x in (
            pb.s_nibbles, pb.h_nibbles, pb.a_tables, pb.r_y, pb.r_sign, pb.pre_ok)],
        ref["vote"][6], per_vote, ref["prior"], corpus.quorum)
    n, bs = MAX_BATCH, MAX_BATCH // mesh.size
    rows = got.reshape(mesh.size, -1)
    require(bool((to_host(svt[0]).int() == rows[:, :bs].reshape(-1)).all()), "radix-13 K5 valid != step")
    require(all(bool((st.cpu() == rows[0, bs : bs + N_TXS]).all()) for st in svt[1]),
            "radix-13 K5 stake != step")
    log(f"radix 13: the sharded step over {[str(d) for d in mesh.devices]} ({n} rows) equals the "
        f"radix-25 packed output bit for bit; K5 over the mesh agrees ({int(rows[:, :bs].sum())} valid)")
    return {"mesh13_rows": n, "mesh13_equal_radix25": True}


def k8_rows(card: dict, k3: dict, dev, launches: dict, ptx: dict) -> tuple[list[dict], dict]:
    """K8 under each kernel of the verify13 library, at the main path's
    shapes: fe13_ops on N_FE elements, dsm_encode13 on N_DSM pairs,
    verify13 (K3 over K8) and verify_tables13 (K5 over K8) on the K3 batch
    of MAX_BATCH rows -- bit-exact against their plain versions (verify13
    over the whole batch, verify_tables13 on a sub-batch) and mask-equal
    to the radix-25 kernel on the whole batch -- each timed beside its
    bound; and the A/B of K3 against verify13 in one window sequence."""
    rows = []
    rng = np.random.default_rng(SEED + 11)
    P = fe13.P_INT
    edge = [0, 1, P - 1, P, P + 18, 2**255 - 1, 2**255 - 19, 19]
    vals = edge + [int.from_bytes(rng.bytes(32), "little") & (2**255 - 1)
                   for _ in range(N_FE - len(edge))]
    other = vals[1:] + vals[:1]

    def limbs(xs):
        return torch.from_numpy(fe13.bytes_to_limbs_np(np.stack(
            [np.frombuffer(x.to_bytes(32, "little"), np.uint8) for x in xs]))).to(dev)

    a, b = limbs(vals), limbs(other)
    k = fe13.fe13_ops(a, b)
    p = fe13.fe13_ops_plain(a, b)
    torch.cuda.synchronize()
    require(bool((k == p).all()), "K8 fe13_ops kernel != plain")
    kh = k.cpu().numpy()
    for i in (0, 1, 2, 3, 4, 5, N_FE - 1):
        x, y = vals[i], other[i]
        want = [(x * y) % P, (x * x) % P, (x - y) % P, pow(x, P - 2, P), x % P]
        require([fe13.limbs_to_int(r) for r in kh[i]] == want, f"K8 row {i} != ints")
    ms = cuda_ms_window(lambda: fe13.fe13_ops(a, b), 50)
    pms = cuda_ms(lambda: fe13.fe13_ops_plain(a, b), 3)
    bnd, by = bound_ms(card, nbytes(a, b, k), N_FE * field.mads(13, fe13.MULS_PER_FE_OPS, fe13.SQS_PER_FE_OPS))
    bnd_sq = bound_ms(card, nbytes(a, b, k), N_FE * field.mads(13, fe13.MULS_PER_FE_OPS, fe13.SQS_PER_FE_OPS,
                                                              sq_as_mul=True))[0]
    rows.append(dict(name="K8 fe25519_13 radix-2^13 field ops (fe_ops kernel of verify13 alone; "
                          "runs inside txf_verify of verify13 on the radix-13 path)",
                     route="cuda", source="txflow_tpu_torch/csrc/fe25519_13.cuh",
                     replaces="txflow_tpu/ops/fe13.py:113", launched_in="txf_verify (verify13)",
                     launches=launches["verify13_tally"], max_abs_err=int((k - p).abs().max()), ms=ms,
                     plain_ms=pms, bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None,
                     shape=f"{N_FE} x (mul,sq,sub,inv,freeze)"))
    log(f"K8 fe13_ops: bit-exact over {N_FE} elements; {ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.5f} ms by {by} "
        f"[{bnd_sq:.5f} with a squaring at a product's cost])")

    # K8's raw products on the edges of their input bound (fe13_ops above
    # sees canonical values only): mul, sq and mul_small(., 2), unfrozen,
    # limb for limb against the plain version, through verify13's
    # txf_fe_prod
    sizes = [N_FE // len(fe13.EDGE_KINDS)] * (len(fe13.EDGE_KINDS) - 1)
    erng = np.random.default_rng(SEED + 37)  # its own stream: the rows below keep their inputs
    pairs = [fe13.bound_edge_limbs(erng, n_k, kind)
             for n_k, kind in zip(sizes + [N_FE - sum(sizes)], fe13.EDGE_KINDS)]
    ea, eb = (torch.from_numpy(np.concatenate(x)).to(dev) for x in zip(*pairs))
    kp = fe13.fe13_prod(ea, eb)
    pp = fe13.fe13_prod_plain(ea, eb)
    torch.cuda.synchronize()
    starts = np.cumsum([0] + [len(x[0]) for x in pairs])
    for kind, lo, hi in zip(fe13.EDGE_KINDS, starts[:-1], starts[1:]):
        require(bool((kp[lo:hi] == pp[lo:hi]).all()), f"K8 fe13_prod kernel != plain on the {kind} inputs")
    ms = cuda_ms_window(lambda: fe13.fe13_prod(ea, eb), 200)
    pms = cuda_ms(lambda: fe13.fe13_prod_plain(ea, eb), 3)
    bnd, by = bound_ms(card, nbytes(ea, eb, kp), N_FE * (field.mads(13, 2, 1) + fe13.NLIMB + 4))
    bnd_sq = bound_ms(card, nbytes(ea, eb, kp), N_FE * (field.mads(13, 2, 1, sq_as_mul=True) + fe13.NLIMB + 4))[0]
    rows.append(dict(name="K8 fe25519_13 raw products on bound-edge inputs (txf_fe_prod of verify13 alone: "
                          "mul, sq, mul_small by 2; runs inside txf_verify of verify13 on the radix-13 path)",
                     route="cuda", source="txflow_tpu_torch/csrc/fe25519_13.cuh",
                     replaces="txflow_tpu/ops/fe13.py:113,140,144", launched_in="txf_verify (verify13)",
                     launches=launches["verify13_tally"], max_abs_err=int((kp - pp).abs().max()), ms=ms,
                     plain_ms=pms, bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq, library_ms=None,
                     shape=f"{N_FE} x (mul, sq, mul_small) over " + ", ".join(fe13.EDGE_KINDS)))
    log(f"K8 fe13_prod: bit-exact over {N_FE} bound-edge elements ({', '.join(fe13.EDGE_KINDS)}); "
        f"{ms:.4f} ms (plain {pms:.1f} ms, bound {bnd:.6f} ms by {by} [{bnd_sq:.6f}])")

    args25 = k3["args"]
    epoch13 = ed25519_batch.EpochTables(k3["keys"], fe_radix=13)
    tables13 = epoch13.device_tables(dev)
    args13 = (*args25[:3], tables13, epoch13.device_quarter_tables(dev), *args25[5:])
    # K2 over K8: scalar pairs
    s_nib = torch.from_numpy(rng.integers(0, 16, (N_DSM, 64), dtype=np.uint8)).to(dev)
    h_nib = torch.from_numpy(rng.integers(0, 16, (N_DSM, 64), dtype=np.uint8)).to(dev)
    vidx = torch.from_numpy(rng.integers(0, N_VALS, N_DSM).astype(np.int32)).to(dev)
    k2 = curve.dsm_encode(s_nib, h_nib, vidx, tables13, fe_radix=13)
    p2 = curve.dsm_encode_plain(s_nib, h_nib, vidx, tables13, fe_radix=13)
    k2_25 = curve.dsm_encode(s_nib, h_nib, vidx, args25[3], fe_radix=25)
    torch.cuda.synchronize()
    require(bool((k2[0] == p2[0]).all() and (k2[1] == p2[1]).all()), "K8 dsm_encode13 kernel != plain")
    require(bool((fe13.frozen_to_bytes(k2[0].cpu().numpy()) == fe.frozen_to_bytes(k2_25[0].cpu().numpy())).all()
                 and (k2[1] == k2_25[1]).all()), "dsm_encode13 != dsm_encode over radix 25")
    ms = cuda_ms_window(lambda: curve.dsm_encode(s_nib, h_nib, vidx, tables13, fe_radix=13), 10)
    pms = cuda_ms(lambda: curve.dsm_encode_plain(s_nib, h_nib, vidx, tables13, fe_radix=13), 2)
    k2_bytes = nbytes(s_nib, h_nib, vidx, tables13, *k2, curve.device_base_quarters(dev, 13)[0])
    bnd, by = bound_ms(card, k2_bytes,
                       N_DSM * field.mads(13, curve.MULS_PER_DSM_ENCODE, curve.SQS_PER_DSM_ENCODE))
    bnd_sq = bound_ms(card, k2_bytes, N_DSM * field.mads(13, curve.MULS_PER_DSM_ENCODE, curve.SQS_PER_DSM_ENCODE,
                                                         sq_as_mul=True))[0]
    rows.append(dict(name="K2 over K8: double-scalar multiply + encode (dsm_encode kernel of verify13 alone, "
                          "four lanes a row by coordinate; the formulas run inside txf_verify of verify13)",
                     route="cuda", **COORD_NOTE,
                     source="txflow_tpu_torch/csrc/ge25519.cuh, txflow_tpu_torch/csrc/verify.cu "
                            "(-DTXF_FE_RADIX=13)",
                     replaces="txflow_tpu/ops/curve.py:162", launched_in="txf_verify (verify13)",
                     launches=launches["verify13_tally"],
                     max_abs_err=int(max((k2[0] - p2[0]).abs().max(), (k2[1] - p2[1]).abs().max())),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, bound_ms_sq_as_mul=bnd_sq,
                     library_ms=None, shape=f"{N_DSM} pairs"))
    log(f"K8 dsm_encode13: bit-exact over {N_DSM} pairs, y and parity equal to radix 25; {ms:.4f} ms "
        f"(plain {pms:.1f} ms, bound {bnd:.5f} ms by {by} [{bnd_sq:.5f}])")

    # K3 over K8: the K3 batch of MAX_BATCH rows, the plain version over the whole batch
    n, n_ok = k3["n"], k3["n_ok"]
    mask25 = k3["mask"]
    k = ed25519_batch.verify_kernel_gather(*args13, fe_radix=13)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    p = ed25519_batch.verify_kernel_gather_plain(*args13, fe_radix=13)
    e1.record()
    torch.cuda.synchronize()
    pms = e0.elapsed_time(e1)
    require(bool((k == p).all()), "K8 verify13 kernel != plain")
    require(bool((k == mask25).all()), "verify13 mask != the radix-25 kernel's")
    require(k[n].item() and not k[n + 1].item(), "radix 13: non-canonical R check failed")
    k3_bytes = nbytes(*args13) + nbytes(curve.device_base_quarters(dev, 13)) + MAX_BATCH * 4
    bnd13, by13 = bound_ms(card, k3_bytes, n_ok * ed25519_batch.mads_per_signature(13))
    bnd13_sq = bound_ms(card, k3_bytes, n_ok * ed25519_batch.mads_per_signature(13, sq_as_mul=True))[0]
    # the A/B: K3 and verify13 in turns (K3, K8, K8, K3)
    ab = []
    for r, args in ((25, args25), (13, args13), (13, args13), (25, args25)):
        ab.append(cuda_ms_window(lambda: ed25519_batch.verify_kernel_gather(*args, fe_radix=r), 10))
    ms = (ab[1] + ab[2]) / 2
    rows.append(dict(name="K3 over K8: ed25519 verify (txf_verify of verify13)", route="cuda",
                     source="txflow_tpu_torch/csrc/verify.cu (-DTXF_FE_RADIX=13), "
                            "txflow_tpu_torch/csrc/fe25519_13.cuh",
                     replaces="txflow_tpu/ops/ed25519_batch.py:384 under txflow_tpu/ops/fe.py:173",
                     launches=launches["verify13_tally"], max_abs_err=int((k.int() - p.int()).abs().max()),
                     ms=ms, plain_ms=pms, bound_ms=bnd13, bound_by=by13, bound_ms_sq_as_mul=bnd13_sq,
                     library_ms=None, **VERIFY_LAUNCH_NOTE,
                     shape=f"{MAX_BATCH} rows, {n_ok} past the host pre-checks",
                     time_note="plain: one run over the whole batch"))
    reg = {lib: ptx[lib]["kernels"].get("txf_verify_kernel", {}) for lib in ("verify", "verify13")}
    ab_line = {"rows": MAX_BATCH, "k3_ms": [ab[0], ab[3]], "verify13_ms": [ab[1], ab[2]],
               "verify13_over_k3": ms / ((ab[0] + ab[3]) / 2),
               "k3_bound_ms": bound_ms(card, 0, n_ok * ed25519_batch.mads_per_signature(25))[0],
               "k3_bound_ms_sq_as_mul": bound_ms(card, 0, n_ok * ed25519_batch.mads_per_signature(
                   25, sq_as_mul=True))[0],
               "verify13_bound_ms": bnd13, "verify13_bound_ms_sq_as_mul": bnd13_sq,
               "registers": {lib: reg[lib].get("registers") for lib in reg},
               "verify13_kernels": ptx["verify13"]["kernels"],
               "stack_bytes": {lib: reg[lib].get("stack_bytes") for lib in reg},
               "spill_store_bytes": {lib: ptx[lib]["spill_store_bytes"] for lib in reg},
               "spill_load_bytes": {lib: ptx[lib]["spill_load_bytes"] for lib in reg}}
    log(f"K8 verify13: bit-exact over {MAX_BATCH} rows (plain over the whole batch), mask equal to "
        f"the radix-25 kernel; {ms:.3f} ms (plain {pms:.1f} ms, bound {bnd13:.4f} ms by {by13} [{bnd13_sq:.4f}])")
    log("A/B K3 (radix 2^25.5) vs verify13 (radix 2^13) at "
        f"{MAX_BATCH} rows, in turns: " + json.dumps(ab_line))

    # K5 over K8: per-vote gathered radix-13 tables; plain on a sub-batch
    vi = args25[2].long().clamp(0, tables13.shape[0] - 1)
    k5_args = (args25[0], args25[1], tables13[vi].contiguous(), args25[5], args25[6], args25[7])
    k5 = ed25519_batch.verify_kernel(*k5_args, fe_radix=13)
    sub = torch.cat([torch.arange(0, min(1024, n), device=dev), torch.tensor([n, n + 1], device=dev)])
    p5 = ed25519_batch.verify_kernel_plain(*(x[sub] for x in k5_args), fe_radix=13)
    torch.cuda.synchronize()
    require(bool((k5[sub] == p5).all()), "K8 verify_tables13 kernel != plain on the sub-batch")
    require(bool((k5 == mask25).all()), "verify_tables13 mask != the radix-25 kernel's")
    ms5 = cuda_ms_window(lambda: ed25519_batch.verify_kernel(*k5_args, fe_radix=13), 10)
    pms5 = cuda_ms(lambda: ed25519_batch.verify_kernel_plain(*(x[sub] for x in k5_args), fe_radix=13), 1)
    k5_bytes = nbytes(*k5_args, curve.device_base_quarters(dev, 13)[0]) + MAX_BATCH * 4
    bnd5, by5 = bound_ms(card, k5_bytes, n_ok * ed25519_batch.mads_per_signature(13, four_lanes=False))
    bnd5_sq = bound_ms(card, k5_bytes, n_ok * ed25519_batch.mads_per_signature(13, four_lanes=False,
                                                                                sq_as_mul=True))[0]
    rows.append(dict(name="K5 over K8: verify over per-vote tables (txf_verify_tables of verify13, four "
                          "lanes a row by coordinate)", **COORD_NOTE,
                     route="cuda", source="txflow_tpu_torch/csrc/verify.cu (-DTXF_FE_RADIX=13)",
                     replaces="txflow_tpu/ops/ed25519_batch.py:146 under txflow_tpu/ops/fe.py:173",
                     launches=launches["verify_tables13"],
                     max_abs_err=int((k5[sub].int() - p5.int()).abs().max()), ms=ms5, plain_ms=pms5,
                     bound_ms=bnd5, bound_by=by5, bound_ms_sq_as_mul=bnd5_sq, library_ms=None,
                     shape=f"{MAX_BATCH} rows, {n_ok} past the host pre-checks",
                     time_note=f"plain: {len(sub)} rows (the sub-batch held bit-exact)"))
    log(f"K8 verify_tables13: bit-exact on {len(sub)} rows, mask equal to radix 25 over {MAX_BATCH}; "
        f"{ms5:.3f} ms (plain {pms5:.1f} ms on the sub-batch, bound {bnd5:.4f} ms by {by5} [{bnd5_sq:.4f}])")
    return rows, ab_line


def wide_check(corpus: Corpus, mesh: Mesh, flow) -> dict:
    """On the int64 path, after the engine's run: the engine's own
    verifier (total power >= 2^30, int64 tally) and the port's
    ScalarVoteVerifier on the same batch -- the first votes in arrival
    order with a nonzero prior -- give the same decisions and stake sums;
    so does a DeviceVoteVerifier of the same set over the round-robin
    mesh (txf_verify_tally64 in its partial form per shard, one
    txf_reduce_quorum64)."""
    n = MAX_BATCH if host_ed.HAVE_CRYPTOGRAPHY else 1024  # the host verifier's time
    vals = flow.val_set
    msgs, sigs, vix, slots, _c = _first_batch(corpus, n, flow.verifier.epoch)
    n_slots = int(slots.max()) + 1
    total = vals.total_voting_power()  # prior stake between 1/3 and 2/3 of it: some slots cross
    prior = np.random.default_rng(SEED + 17).integers(total // 3, total * 2 // 3, n_slots)
    got = flow.verifier.verify_and_tally(msgs, sigs, vix, slots, n_slots, prior_stake=prior)
    want = ScalarVoteVerifier(vals).verify_and_tally(msgs, sigs, vix, slots, n_slots, prior_stake=prior)
    sharded, ops = count_step_ops(DeviceVoteVerifier(vals, mesh=mesh, fe_radix=25).verify_and_tally,
                                  msgs, sigs, vix, slots, n_slots, prior_stake=prior)
    # n votes are one step of the mesh verifier: a fused partial a shard, one reduce
    require(ops["launches"] == {"verify_partial64": mesh.size, "reduce_quorum64": 1}
            and ops["copies"] <= 2 * (mesh.size - 1),
            f"the int64 sharded step made {ops}: want {mesh.size} fused partials, 1 reduce, "
            f"<= {2 * (mesh.size - 1)} copies")
    for name, r in (("one card", got), ("mesh", sharded)):
        for f in ("valid", "stake", "maj23", "dropped"):
            require(np.array_equal(getattr(r, f), getattr(want, f)), f"int64 tally ({name}) {f} != scalar")
    require(int(want.stake.max()) >= 2**31 and 0 < int(want.maj23.sum()) < n_slots,
            "int64 check too weak")
    log(f"int64 tally: the engine's verifier and a {mesh.size}-shard one equal ScalarVoteVerifier on "
        f"{n} votes over {n_slots} slots (stake up to {int(want.stake.max())}, "
        f"{int(want.maj23.sum())} slots at quorum); the sharded step made {ops}")
    return {"wide_check_votes": n, "wide_check_slots": n_slots, "wide_check_max_stake": int(want.stake.max()),
            "wide_mesh_step": ops}


def wide_rows(card: dict, corpus: Corpus, k3: dict, dev, launches: dict, scale: int,
              mesh_step: dict) -> list[dict]:
    """The int64 tally kernels at the main path's shapes (the K3 batch of
    MAX_BATCH votes over N_TXS slots, powers ``scale`` times the corpus'),
    each bit-exact against its plain version and timed beside its bound
    and one PyTorch call of the same function. ``mesh_step`` is
    ``count_step_ops``'s count of the int64 sharded step (``wide_check``):
    the reduce row's launches a step."""
    rows = []
    args, S = k3["args"], N_TXS
    valid = k3["mask"].int()
    slot_t, vidx = k3["slot"], args[2]
    powers = torch.zeros(32, dtype=torch.int64, device=dev)
    powers[:N_VALS] = torch.tensor(corpus.powers, dtype=torch.int64) * scale
    prior = k3["prior"].long() * scale
    quorum = (int(powers.sum()) * 2) // 3 + 1
    sw = torch.empty(2 * S, dtype=torch.int32, device=dev)
    mj = torch.empty(S, dtype=torch.int32, device=dev)
    tally.tally_into(sw, mj, valid, slot_t, vidx, powers, prior, quorum)
    pst, pmj = tally.tally_plain(valid.bool(), slot_t, vidx, powers, prior, quorum)
    torch.cuda.synchronize()
    kst = sw.view(torch.int64)
    require(bool((kst == pst).all() and (mj == pmj).all()), "tally64 kernel != plain")
    require(int(pst.max()) >= 2**31 and 0 < int(pmj.sum()) < S, "tally64 case too weak")
    ms = cuda_ms_window(lambda: tally.tally_into(sw, mj, valid, slot_t, vidx, powers, prior, quorum), 500, warmup=5)
    pms = cuda_ms(lambda: tally.tally_plain(valid.bool(), slot_t, vidx, powers, prior, quorum), 20, warmup=2)
    slot_c, in_range, val_c = slot_t.long().clamp(0, S - 1), (slot_t >= 0) & (slot_t < S), vidx.long()
    vb = valid.bool()

    def library_tally():
        return prior.index_add(0, slot_c, torch.where(vb & in_range, powers[val_c], 0)) >= quorum

    require(bool((library_tally().int() == pmj).all()), "index_add int64 tally != plain")
    lib_ms = cuda_ms_window(library_tally, 500, warmup=5)
    bnd, by = bound_ms(card, nbytes(valid, slot_t, vidx, powers, prior, sw, mj), MAX_BATCH + S)
    rows.append(dict(name="K4 int64 stake tally, standalone (txf_tally64)", route="cuda",
                     source="txflow_tpu_torch/csrc/tally.cu", replaces="txflow_tpu/ops/tally.py:114",
                     launches=launches["tally64"],
                     max_abs_err=int(max((kst - pst).abs().max(), (mj - pmj).abs().max())),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                     shape=f"{MAX_BATCH} votes, {S} slots, total power {int(powers.sum())}",
                     **small_kernel_split(lambda: tally.tally_into(sw, mj, valid, slot_t, vidx, powers,
                                                                   prior, quorum))))
    log(f"K4 tally64: bit-exact ({int(pmj.sum())} slots at quorum, stake up to {int(pst.max())}); "
        f"{ms:.4f} ms (plain {pms:.3f}, index_add {lib_ms:.4f}, bound {bnd:.6f} ms by {by})")

    # the partial of each of 4 shards, then their reduction with the prior
    bs = MAX_BATCH // MESH_SHARDS
    parts = [tally.tally_partial(valid[i * bs:(i + 1) * bs], slot_t[i * bs:(i + 1) * bs],
                                 vidx[i * bs:(i + 1) * bs], powers, S) for i in range(MESH_SHARDS)]
    plains = [tally.tally_partial_plain(valid[i * bs:(i + 1) * bs], slot_t[i * bs:(i + 1) * bs],
                                        vidx[i * bs:(i + 1) * bs], powers, S) for i in range(MESH_SHARDS)]
    torch.cuda.synchronize()
    require(all(bool((a == b).all()) for a, b in zip(parts, plains)) and parts[0].dtype == torch.int64,
            "tally_partial64 kernel != plain")
    v0, s0, i0 = valid[:bs], slot_t[:bs], vidx[:bs]
    ms = cuda_ms_window(lambda: tally.tally_partial(v0, s0, i0, powers, S), 500, warmup=5)
    pms = cuda_ms(lambda: tally.tally_partial_plain(v0, s0, i0, powers, S), 20, warmup=2)
    zeros = torch.zeros(S, dtype=torch.int64, device=dev)
    sc0, ir0 = s0.long().clamp(0, S - 1), (s0 >= 0) & (s0 < S)

    def library_partial():
        return zeros.index_add(0, sc0, torch.where((v0 > 0) & ir0, powers[i0.long()], 0))

    require(bool((library_partial() == parts[0]).all()), "index_add int64 partial != kernel")
    lib_ms = cuda_ms_window(library_partial, 500, warmup=5)
    bnd, by = bound_ms(card, nbytes(v0, s0, i0, powers) + S * 8, bs)
    rows.append(dict(name="K7 int64 per-shard partial tally, standalone (txf_tally_partial64)",
                     route="cuda",
                     source="txflow_tpu_torch/csrc/tally.cu", replaces="txflow_tpu/parallel/mesh.py:114",
                     launches=launches["tally_partial64"],
                     max_abs_err=int(max((a - b).abs().max() for a, b in zip(parts, plains))),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                     shape=f"{bs} votes (one of {MESH_SHARDS} shards), {S} slots",
                     **small_kernel_split(lambda: tally.tally_partial(v0, s0, i0, powers, S))))
    log(f"K7 partial64: bit-exact on {MESH_SHARDS} shards; {ms:.4f} ms (plain {pms:.3f}, index_add "
        f"{lib_ms:.4f}, bound {bnd:.6f} ms by {by})")
    stacked = torch.stack(parts)
    rst, rmj = tally.reduce_quorum(stacked, prior, quorum)
    pst2, pmj2 = tally.reduce_quorum_plain(stacked, prior, quorum)
    torch.cuda.synchronize()
    require(bool((rst == pst2).all() and (rmj == pmj2).all() and (rst == pst).all()),
            "reduce_quorum64 kernel != plain (or != the one-card tally)")
    ms = cuda_ms_window(lambda: tally.reduce_quorum(stacked, prior, quorum), 500, warmup=5)
    pms = cuda_ms(lambda: tally.reduce_quorum_plain(stacked, prior, quorum), 20, warmup=2)

    def library_reduce():
        total = stacked.sum(0) + prior
        return total, total >= quorum

    lt, lm = library_reduce()
    require(bool((lt == rst).all() and (lm.int() == rmj).all()), "torch int64 reduction != kernel")
    lib_ms = cuda_ms_window(library_reduce, 500, warmup=5)
    bnd, by = bound_ms(card, nbytes(stacked, prior) + S * 8 + S * 4, (MESH_SHARDS + 1) * S)
    per_step = mesh_step["launches"]["reduce_quorum64"]
    rows.append(dict(name="K7 int64 psum: partials + prior >= quorum (txf_reduce_quorum64)", route="cuda",
                     source="txflow_tpu_torch/csrc/tally.cu", replaces="txflow_tpu/ops/tally.py:101",
                     launches=launches["reduce_quorum64"],
                     max_abs_err=int(max((rst - pst2).abs().max(), (rmj - pmj2).abs().max())),
                     ms=ms, plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
                     shape=f"{MESH_SHARDS} partials x {S} slots",
                     launches_per_mesh_step=per_step, per_step_ms=per_step * ms,
                     library_per_step_ms=lib_ms,
                     **small_kernel_split(lambda: tally.reduce_quorum(stacked, prior, quorum))))
    log(f"K7 reduce64: bit-exact, equal to the one-card int64 tally; {ms:.4f} ms (plain {pms:.3f}, "
        f"stack().sum(0) + prior and compare {lib_ms:.4f}, bound {bnd:.6f} ms by {by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 11: gossip and the fast-path node -- BASELINE config 2 on one card


class NetCorpus:
    """BASELINE config 2's corpus (``bench.py:690-760``): ``n_txs`` txs and
    one vote each by ``n_vals`` validators at power ``NET_POWER``, signed
    before the timed loop, with config 4's check mix (``bench.py:736-741``):
    for 1/16 of the txs (chosen from the seed) validator 0's signature has
    a flipped S byte, so the tx commits without that vote; for another
    1/16 validators 0 and 1 are both corrupted, leaving half the stake
    honest, so the tx commits on no node."""

    def __init__(self, seed: int, n_vals: int = 4, n_txs: int = 25_000):
        rng = np.random.default_rng(seed)
        self.n_vals, self.n_txs = n_vals, n_txs
        seeds = [rng.bytes(32) for _ in range(n_vals)]
        self.priv_vals = [MockPV(s) for s in seeds]
        self.val_set = ValidatorSet([Validator.from_pub_key(pv.get_pub_key(), NET_POWER)
                                     for pv in self.priv_vals])
        self.txs = [b"ntx%05d=%d" % (i, i) for i in range(n_txs)]
        perm = rng.permutation(n_txs)
        k = n_txs // 16
        self.one_bad = set(perm[:k].tolist())  # validator 0 corrupted
        self.two_bad = set(perm[k : 2 * k].tolist())  # validators 0 and 1 corrupted
        self.votes_by_val: list[list[TxVote]] = [[] for _ in range(n_vals)]
        items = []
        for t, tx in enumerate(self.txs):
            key = hashlib.sha256(tx).digest()
            for v, pv in enumerate(self.priv_vals):
                vote = TxVote(0, key.hex().upper(), key, 1_700_000_000_000_000_000 + t,
                              pv.get_address())
                items.append((seeds[v], vote.sign_bytes(NET_CHAIN)))
                self.votes_by_val[v].append(vote)
        t0 = time.perf_counter()
        sigs = iter(_sign_all(items))
        self.sign_s = time.perf_counter() - t0
        self.bad_sigs: set[bytes] = set()
        for t in range(n_txs):
            for v in range(n_vals):
                sig = next(sigs)
                if (v == 0 and (t in self.one_bad or t in self.two_bad)) or (
                        v == 1 and t in self.two_bad):
                    sig = sig[:45] + bytes([sig[45] ^ 0x01]) + sig[46:]  # an S byte
                    self.bad_sigs.add(sig)
                self.votes_by_val[v][t].signature = sig
        self.expect = [t not in self.two_bad for t in range(n_txs)]
        self.n_votes = n_vals * n_txs


def _thread_cpu_s() -> dict[str, float]:
    """CPU seconds of every live thread, added up by name with the node's
    and the peer's ids taken out (``txflow``, ``p2p-recv``, ...)."""
    out: dict[str, float] = {}
    for t in threading.enumerate():
        try:
            s = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, TypeError, AttributeError):
            continue
        name = t.name.split("-node")[0]
        out[name] = out.get(name, 0.0) + s
    return out


def localnet_phase(dev, corpus: "NetCorpus | None" = None, n_txs: int = NET_TXS,
                   chunk: int = NET_CHUNK, timeout: float = 300.0) -> dict:
    """BASELINE config 2 through the port's node, by ``bench.py``'s
    protocol (``bench.py:1-18,690-760,794-831``): a ``LocalNet`` of 4
    validators at power 10 (quorum 27 of 40) hosting 4 nodes over
    in-memory pipes in a full mesh; one ``DeviceVoteVerifier`` on the
    card with ``shared_cache=True`` and buckets (4096, 16384) serves the
    four engines, which share its process host-prep pool; ``sign=False``,
    ``mempool_broadcast=False``. Txs are seeded into every mempool a chunk
    at a time (``check_tx_many``), then validator v's votes of the chunk
    enter node v's vote pool, and vote gossip fans them out; the timed
    loop ends when every node has committed every tx that should commit.

    The gate: exactly the expected txs commit on every node; no
    certificate holds a corrupted vote, each holds more than 2/3 of the
    stake; the four kvstore states are equal (and hold exactly the
    expected keys); ``verify`` launches above 0, no fused step, and no
    plain version ran; the cache's verify rows (each launch's real rows)
    do not exceed the distinct votes."""
    from txflow_tpu_torch.node import LocalNet
    from txflow_tpu_torch.utils.config import test_config
    from txflow_tpu_torch.utils.events import EventTx

    corpus = corpus or NetCorpus(SEED + 11, n_txs=n_txs)
    log(f"localnet corpus: {corpus.n_votes} votes signed in {corpus.sign_s:.1f} s; "
        f"{len(corpus.one_bad)} txs with validator 0 corrupted, {len(corpus.two_bad)} with "
        f"validators 0 and 1 (never commit)")
    cfg = test_config()
    # the pools hold the whole corpus, as the JAX bench sizes them
    cfg.mempool.size = max(cfg.mempool.size, 4 * corpus.n_txs * (corpus.n_vals + 1))
    cfg.mempool.cache_size = max(cfg.mempool.cache_size, 2 * cfg.mempool.size)
    cfg.engine.device = dev.type
    cfg.engine.min_batch = 3072  # bench.py's device defaults
    cfg.engine.batch_wait = 0.05
    cfg.engine.host_prep_workers = NET_PREP_WORKERS
    cfg.engine.host_prep_backend = "process"
    verifier = DeviceVoteVerifier(corpus.val_set, device=dev,
                                  buckets=(NET_BUCKET, 4 * NET_BUCKET), shared_cache=True)
    net = LocalNet(corpus.n_vals, chain_id=NET_CHAIN, config=cfg, priv_vals=corpus.priv_vals,
                   sign=False, mempool_broadcast=False, verifier=verifier, device=dev.type)
    require(net.val_set.hash() == corpus.val_set.hash(), "the net's set is not the corpus'")
    commit_t: list[dict[str, float]] = [dict() for _ in net.nodes]
    for i, node in enumerate(net.nodes):
        node.event_bus.subscribe_callback(
            EventTx, lambda ev, d=commit_t[i]: d.__setitem__(ev.data.tx_hash, time.perf_counter()))
    plain_calls = {"n": 0}
    plains = {m: [(n, getattr(m, n)) for n in names] for m, names in (
        (ed25519_batch, ("verify_kernel_gather_plain", "verify_kernel_plain")),
        (tally, ("compact_step_packed_plain", "tally_plain")))}

    def counting(fn):
        def wrapped(*a, **k):
            plain_calls["n"] += 1
            return fn(*a, **k)
        return wrapped

    for m, fns in plains.items():
        for n, fn in fns:
            setattr(m, n, counting(fn))
    host_calls, restore_host = _count_host_verifies()
    hashes = [hashlib.sha256(tx).hexdigest().upper() for tx in corpus.txs]
    want = [tx for tx, ok in zip(corpus.txs, corpus.expect) if ok]
    inject_t: dict[str, float] = {}
    try:
        t0 = time.perf_counter()
        net.start()
        start_s = time.perf_counter() - t0
        log(f"localnet: start() {start_s:.1f} s (4 nodes: warm steps, host-prep pool, mesh)")
        _lib.reset_launches()  # the counts of the main path's run from here
        cpu0 = _thread_cpu_s()
        # the card's busy time over the loop: every kernel and copy in a
        # CUDA-only profiler trace (events around a launch would also time
        # the host's gaps, with 60 threads on one interpreter lock)
        trace = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            trace = profile(activities=[ProfilerActivity.CUDA])
        with trace or contextlib.nullcontext(), GcClock() as gcc:
            t0 = time.perf_counter()
            for base in range(0, corpus.n_txs, chunk):
                tx_chunk = corpus.txs[base : base + chunk]
                for node in net.nodes:
                    require(not any(node.mempool.check_tx_many(tx_chunk)),
                            "a mempool rejected a tx")
                t_chunk = time.perf_counter()
                for h in hashes[base : base + chunk]:
                    inject_t[h] = t_chunk
                for v, node in enumerate(net.nodes):
                    node.tx_vote_pool.check_tx_many(corpus.votes_by_val[v][base : base + chunk])
            require(net.wait_all_committed(want, timeout=timeout),
                    f"not every node committed every tx in {timeout} s")
            wall = time.perf_counter() - t0
            torch.cuda.synchronize() if dev.type == "cuda" else None
        cpu1 = _thread_cpu_s()
        launches = dict(_lib.launches)
        try:
            device = trace_device_ms(trace) if trace is not None else {}
        except Exception as e:  # noqa: BLE001 -- a measurement, never a check
            device = {"error": repr(e)}
    finally:
        for m, fns in plains.items():
            for n, fn in fns:
                setattr(m, n, fn)
        restore_host()
        net.stop()
    require(verifier.staging_stats() is None, "the last engine's stop left the verifier open")
    # -- the gate --
    power = {v.address: v.voting_power for v in net.val_set}
    quorum = net.val_set.quorum_power()
    states = []
    for i, node in enumerate(net.nodes):
        flow = node.txflow
        for h, ok in zip(hashes, corpus.expect):
            require(flow.is_tx_committed(h) == ok, f"node {i}: tx {h[:12]} committed != {ok}")
            if not ok:
                continue
            cert = flow.load_commit(h)
            require(cert is not None, f"node {i}: no certificate for {h[:12]}")
            require(not any(cs.signature in corpus.bad_sigs for cs in cert.commits),
                    f"node {i}: a corrupted vote in a certificate")
            stake = sum(power[cs.validator_address] for cs in cert.commits)
            require(3 * stake > 2 * net.val_set.total_voting_power() and stake >= quorum,
                    f"node {i}: certificate of {stake} below 2/3")
        states.append(dict(node.app.state))
    want_keys = {tx.split(b"=")[0] for tx in want}
    require(all(s == states[0] for s in states) and set(states[0]) == want_keys,
            "the kvstore states differ between nodes or from the expected keys")
    require(launches["verify"] > 0, "no verify launch on the LocalNet path")
    require(launches[fused_kernel()] == 0, "a fused step ran on the cache path")
    require(plain_calls["n"] == 0, f"{plain_calls['n']} plain-version calls on the card")
    require(host_calls["n"] == 0, f"{host_calls['n']} host verifies")
    require(verifier.cache_verify_rows <= corpus.n_votes,
            f"{verifier.cache_verify_rows} rows verified for {corpus.n_votes} distinct votes")
    lat_ms = sorted((d[h] - inject_t[h]) * 1e3 for d in commit_t for h in d if h in inject_t)
    committed_votes = net.committed_votes_total()
    threads = {k: cpu1.get(k, 0.0) - cpu0.get(k, 0.0) for k in cpu1}
    out = {
        "validators": corpus.n_vals, "nodes": len(net.nodes), "txs": corpus.n_txs,
        "votes": corpus.n_votes, "chunk": chunk, "buckets": list(verifier.buckets),
        "miss_buckets": list(verifier.miss_buckets),
        "committed_txs_per_node": sum(corpus.expect),
        "committed_votes": committed_votes,
        "committed_votes_per_s": committed_votes / wall,
        "p50_commit_ms": _pct(lat_ms, 50), "p99_commit_ms": _pct(lat_ms, 99),
        "latency_samples": len(lat_ms),
        "wall_s": wall, "start_s": start_s, "sign_s": corpus.sign_s,
        "device_ms": device.get("total"),
        "device_share": device["total"] / (wall * 1e3) if "total" in device else None,
        "device_ms_by_name": device,
        "gc_s": gcc.s, "gc_collections": gcc.collections,
        "cpu_s_by_thread": {k: round(v, 3) for k, v in sorted(threads.items()) if v > 0.01},
        "cache": {"hits": verifier.cache.hits, "misses": verifier.cache.misses,
                  "deferrals": verifier.cache.deferrals,
                  "verify_rows": verifier.cache_verify_rows,
                  "verify_calls": verifier.cache_verify_calls},
        "launches": {k: v for k, v in launches.items() if v},
        "verify_launches": launches["verify"],
    }
    log(f"localnet: {committed_votes} certificate votes on 4 nodes in {wall:.2f} s = "
        f"{out['committed_votes_per_s']:.0f} votes/s; commit p50 {out['p50_commit_ms']:.1f} ms, "
        f"p99 {out['p99_commit_ms']:.1f} ms; verify {launches['verify']} launches; "
        f"the card busy {out['device_ms']} ms = {out['device_share']} of the wall; "
        f"gc {gcc.s:.2f} s; cache hits {verifier.cache.hits}, misses {verifier.cache.misses}, "
        f"deferrals {verifier.cache.deferrals}")
    return out


def cross_card_phase() -> None:
    """K1, K2 and K3 on every visible card, the last card first, against
    their plain versions on the CPU and, for K3, the golden model."""
    n_cards = torch.cuda.device_count()
    require(n_cards > 1, "--cross-card needs more than one card")
    rng = np.random.default_rng(SEED + 2)
    seeds = [rng.bytes(32) for _ in range(4)]
    pubs = [host_ed.public_key_from_seed(s) for s in seeds]
    epoch = ed25519_batch.EpochTables(pubs, fe_radix=25)
    n = 32
    msgs = [rng.bytes(48) for _ in range(n)]
    vix = rng.integers(0, 4, n)
    sigs = host_ed.sign_batch([(seeds[v], m) for v, m in zip(vix, msgs)])
    for j in range(0, n, 3):  # a third of the signatures corrupted
        sigs[j] = sigs[j][:9] + bytes([sigs[j][9] ^ 0x04]) + sigs[j][10:]
    want = np.array([host_ed.verify_pure(pubs[v], m, g) for v, m, g in zip(vix, msgs, sigs)])
    batch = ed25519_batch.prepare_compact(msgs, sigs, vix, epoch)
    cpu = torch.device("cpu")
    k3_args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        batch.s_nibbles, batch.h_nibbles, batch.val_idx)] + [
        epoch.device_tables(cpu), epoch.device_quarter_tables(cpu)] + [
        torch.from_numpy(np.ascontiguousarray(x)) for x in (batch.r_y, batch.r_sign, batch.pre_ok)]
    k2_args = k3_args[:4]
    fe_a = torch.from_numpy(fe.bytes_to_limbs_np(
        np.frombuffer(rng.bytes(32 * 256), np.uint8).reshape(256, 32) & 0x7F))
    fe_b = fe_a.roll(1, 0)
    p1 = fe.fe_ops_plain(fe_a, fe_b)
    p2 = curve.dsm_encode_plain(*k2_args)
    require(bool((ed25519_batch.verify_kernel_gather_plain(*k3_args).numpy() == want).all()),
            "plain verify != verify_pure")
    _lib.reset_launches()
    for card in reversed(range(n_cards)):
        dev = torch.device("cuda", card)
        k1 = fe.fe_ops(fe_a.to(dev), fe_b.to(dev)).cpu()
        k2 = [t.cpu() for t in curve.dsm_encode(*[t.to(dev) for t in k2_args])]
        k3 = ed25519_batch.verify_kernel_gather(*[t.to(dev) for t in k3_args]).cpu()
        require(bool((k1 == p1).all()), f"K1 on cuda:{card} != plain")
        require(bool((k2[0] == p2[0]).all() and (k2[1] == p2[1]).all()), f"K2 on cuda:{card} != plain")
        require(bool((k3.numpy() == want).all()), f"K3 on cuda:{card} != verify_pure")
        log(f"cross-card: cuda:{card} ({torch.cuda.get_device_name(card)}): K1, K2, K3 "
            f"bit-exact ({int(want.sum())}/{n} signatures valid)")
    require(all(_lib.launches[k] == n_cards for k in ("fe_ops", "dsm_encode", "verify")),
            f"launches {_lib.launches} for {n_cards} cards")


def _mesh_corpus() -> Corpus:
    t0 = time.perf_counter()
    corpus = Corpus(SEED + 7, n_vals=MESH_VALS, n_txs=MESH_TXS, byz=MESH_BYZ,
                    byz_p=MESH_BYZ_P, prefix=b"mtx")
    log(f"mesh corpus: {len(corpus.votes)} votes signed in {corpus.sign_s:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with setup); {sum(corpus.byzantine)} byzantine; "
        f"{int(corpus.expect_commit.sum())}/{MESH_TXS} txs reach quorum on honest stake")
    return corpus


def _threaded_json(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("step_s", "stage_ms_by_thread", "pool")}


def _mesh_json(mp: dict) -> dict:
    return {"mesh": {k: ({kk: vv for kk, vv in v.items() if kk != "step_s"} if isinstance(v, dict)
                         else v) for k, v in mp.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_info()
    log(card["smi"])
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{card['sms']} SMs, max SM clock {card['max_sm_mhz']:.0f} MHz")
    t0 = time.perf_counter()
    _lib.build_all(force=True)
    card["build_s"] = time.perf_counter() - t0
    log(f"build: {card['build_s']:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a, in parallel)")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if sys.argv[1:] == ["--cross-card"]:
        cross_card_phase()
        log(json.dumps({"cards": torch.cuda.device_count()}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if sys.argv[1:] == ["--mesh"]:
        require(torch.cuda.device_count() >= MESH_SHARDS,
                f"--mesh needs {MESH_SHARDS} cards, {torch.cuda.device_count()} visible")
        mesh = make_mesh(MESH_SHARDS)  # distinct cards, as the engine builds it
        mcorpus = _mesh_corpus()
        mp, fb, one_res = mesh_phase(mcorpus, mesh, engine_builds_mesh=True)
        rows = mesh_rows(card, mcorpus, mesh, fb, mp["launches"], mp["mesh"]["steps"])
        thm = threaded_phase(mcorpus, mesh.devices[0], one_res, mp["mesh"], "threaded mesh",
                             mesh=mesh, engine_builds_mesh=True, max_batch=MESH_BATCH,
                             max_slots=MESH_SLOTS)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_mesh.json"), "w") as f:
            json.dump({"card": card, "kernels": rows, "mesh": mp, "threaded_mesh": thm}, f,
                      indent=1)
        log(json.dumps(_mesh_json(mp)))
        log(json.dumps({"threaded_mesh": _threaded_json(thm)}))
        log(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    if sys.argv[1:] == ["--localnet"]:
        ln = localnet_phase(torch.device("cuda"))
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "chip_smoke_localnet.json"), "w") as f:
            json.dump({"card": card, "localnet": ln}, f, indent=1)
        log(json.dumps({"localnet": ln}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    require(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    for name in _lib.LIBS:
        txt = (_lib.BUILD / f"lib{name}.build.txt").read_text()
        log("\n".join(f"  {name}: {ln.strip()}" for ln in txt.splitlines()
                      if "Used" in ln or "spill" in ln or "Function properties" in ln))
    ptx = ptxas_info()
    log("ptxas (registers, stack and spill bytes by library): " + json.dumps(ptx))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    corpus = Corpus(SEED)
    log(f"corpus: {len(corpus.votes)} votes signed in {corpus.sign_s:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with setup); {sum(corpus.byzantine)} byzantine; "
        f"{int(corpus.expect_commit.sum())}/{N_TXS} txs reach quorum on honest stake")
    rows, k3 = kernel_phase(card, corpus, dev)
    qc = quarter_checks(card, k3, dev, ptx)
    frows, fused = fused_rows(card, k3, dev)
    sl, sl_res = slice_phase(corpus, dev)
    ths = threaded_phase(corpus, dev, sl_res, sl, "threaded slice")
    ths_inline = threaded_phase(corpus, dev, sl_res, sl, "threaded slice, commits inline",
                                pipeline_commits=False)
    sl_again = serial_again(corpus, dev, sl_res, "serial slice again")
    lp = lanes_phase(dev)
    ln = localnet_phase(dev)
    by_name = {"K1": "verify_tally", "K2": "verify_tally", "K3": "verify_tally", "K4": "tally"}
    for r in rows:
        r["launches"] = sl["launches"][by_name[r["name"][:2]]]
        if r["name"][:2] == "K3":
            # the LocalNet path launches K3 as txf_verify alone (the cache path)
            r["launches_by_path"] = {"slice": r["launches"], "localnet": ln["verify_launches"]}
    rows += k3_rung_rows(card, k3, dev, lp["k3_launches_by_rung"])
    # the radix-2^13 field (K8): the slice, a sharded step and K5 over the
    # round-robin mesh, all between one reset and one read of the counts
    mesh_rr = round_robin_mesh(MESH_SHARDS)
    ref13 = radix13_mesh_reference(corpus, mesh_rr)
    s13, _ = slice_phase(corpus, dev, fe_radix=13, ref=sl_res, label="radix-13 slice",
                         extra=lambda flow: radix13_mesh_path(corpus, mesh_rr, ref13))
    k8, ab = k8_rows(card, k3, dev, s13["launches"], ptx)
    rows += k8
    # total power >= 2^30: every power times 2^25, the int64 tally
    scale = 2**25
    wide, _ = slice_phase(corpus, dev, scale=scale, ref=sl_res, label="int64 slice",
                          extra=lambda flow: wide_check(corpus, mesh_rr, flow))
    require(wide["launches"]["verify_partial64"] > 0 and wide["launches"]["reduce_quorum64"] > 0,
            "the int64 mesh kernels never ran")
    rows += wide_rows(card, corpus, k3, dev, wide["launches"], scale, wide["wide_mesh_step"])
    t0 = time.perf_counter()
    com = CommitteeCorpus(SEED + 3)
    log(f"committee corpus: {len(com.votes)} votes signed in {com.sign_s:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with setup); {sum(com.byzantine)} byzantine; "
        f"{int(com.expect_commit.sum())}/{len(com.txs)} txs reach the committee quorum on honest stake")
    k6 = k6_rows(card, com, dev)
    cm = committee_phase(com, dev)
    for r in k6:
        r["launches"] = cm["k6_launches"]  # K6 launches of the committee path, all rungs
        # txf_verify alone also serves the LocalNet's cache path (all rungs)
        r["launches_by_path"] = {"committee": cm["k6_launches"],
                                 "localnet": ln["verify_launches"]}
    # the device's busy share of the committee steps: each step's K6 launch
    # at its kernel-row time (many launches in one window), over step time
    row_ms = {r["rung"]: r["ms"] for r in k6}
    step_rungs = cm["k6_calls_by_phase_and_rung"]["step"]
    cm["k6_busy_share_from_rows"] = (
        sum(row_ms[g] * n for g, n in step_rungs.items()) / (sum(cm["step_s"]) * 1e3)
        if all(g in row_ms for g in step_rungs) else None)
    log(f"committee: K6 busy share of the step time (kernel-row ms x launches) "
        f"{cm['k6_busy_share_from_rows']}")
    rows += k6
    k6_13 = k6_rows(card, com, dev, fe_radix=13, rungs=(8, 16384))
    for r in k6_13:
        r["launches"] = cm["k6_13_launches"]  # K6 over K8 launches of the radix-13 follower
    rows += k6_13
    # the mesh-sharded serving step: 4 shards over the visible cards in turn
    mcorpus = _mesh_corpus()
    mesh = round_robin_mesh(MESH_SHARDS)
    mp, fb, one_res = mesh_phase(mcorpus, mesh, engine_builds_mesh=False)
    rows += mesh_rows(card, mcorpus, mesh, fb, mp["launches"], mp["mesh"]["steps"])
    thm = threaded_phase(mcorpus, mesh.devices[0], one_res, mp["mesh"], "threaded mesh",
                         mesh=mesh, max_batch=MESH_BATCH, max_slots=MESH_SLOTS)
    # the fused rows' launches: each path's count of its fused entry
    for r in frows:
        name = r.pop("launch_name")
        by_path = {
            "verify_tally": {"slice": sl["engine_launches"][name],
                             "threaded_slice": ths["launches"][name],
                             "threaded_slice_commits_inline": ths_inline["launches"][name],
                             "lanes": {k: run["launches"][name] for k, run in lp["runs"].items()},
                             "mesh_one_card": mp["one_card_launches"][name]},
            "verify_tally64": {"int64_slice": wide["engine_launches"][name]},
            "verify_partial": {"mesh": mp["engine_launches"][name],
                               "threaded_mesh": thm["launches"][name]},
        }[name]
        r["launches"] = next(iter(by_path.values()))
        r["launches_by_path"] = by_path
    rows += frows
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "ptxas": ptx, "kernels": rows, "txf_verify_quarters": qc,
                   "fused_verify_tally": fused, "slice": sl,
                   "threaded_slice": ths, "threaded_slice_commits_inline": ths_inline,
                   "serial_slice_again": sl_again, "lanes": lp,
                   "radix13_slice": s13, "int64_slice": wide,
                   "ab_k3_verify13": ab, "committee": cm, "mesh": mp, "threaded_mesh": thm,
                   "localnet": ln},
                  f, indent=1)
    for name, run in (("threaded_slice", ths), ("threaded_slice_commits_inline", ths_inline),
                      ("threaded_mesh", thm)):
        log(json.dumps({name: _threaded_json(run)}))
    for name, run in lp["runs"].items():
        log(json.dumps({f"lanes_{name}": {k: v for k, v in run.items()
                                          if k not in ("device_ms_per_step",)}}))
    for name, run in (("radix13_slice", s13), ("int64_slice", wide)):
        log(json.dumps({name: {k: v for k, v in run.items() if k != "step_s"}}))
    log(json.dumps({"ab_k3_verify13": ab}))
    log(json.dumps({"txf_verify_quarters": qc}))
    log(json.dumps({"fused_verify_tally": fused}))
    log(json.dumps({"committee": {k: v for k, v in cm.items() if k not in (
        "step_s", "vote_heights_per_response", "k6_one_launch_window_ms_per_group",
        "k6_main_path_checked")}}))
    log(json.dumps(_mesh_json(mp)))
    log(json.dumps({"localnet": ln}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
