"""PyTorch port, the tally fused into the verify's encode launch (K4 on
one card, the shard partial of K7) and the mesh psum reduced once a step.

On the CPU the fused step runs its plain versions; these tests hold them
against the JAX package at tolerance 0: ``compact_step_packed`` and
``compact_step_partial`` in int32 and int64 over both fields, on a batch
holding rows whose pre-checks failed, slots below 0 and at or past S,
validator indices out of range and a prior that already holds slots at
quorum (int64: every power and the prior times 2^25, so the JAX int32
step scaled by 2^25 is the reference, exactly); the sharded step over
CPU meshes of 1, 2 and 4 entries against the JAX
``sharded_compact_step_packed_cached`` output, with one ``reduce_quorum``
a step, at most 2(n - 1) psum copies, and every shard's stake and maj23
equal to shard 0's. The CUDA wrapper's one call (the kernel's name, the C
entry and its argument count, the scratch layout) is checked with the
launch faked, as tests/test_torch_launch.py fakes it."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_verifier import make_batch, make_valset
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.ops import tally as jtally
from txflow_tpu.parallel import make_mesh as jax_make_mesh
from txflow_tpu.parallel.mesh import sharded_compact_step_packed_cached
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import _lib, curve, ed25519_batch, fe, fe13, tally
from txflow_tpu_torch.parallel import mesh as pm
from txflow_tpu_torch.types import Validator, ValidatorSet
from txflow_tpu_torch.verifier import DeviceVoteVerifier, ScalarVoteVerifier

SCALE = 2**25  # int64 form: powers and prior times 2^25 (total power past 2^30)
B, N, S, V = 64, 24, 64, 4  # the shapes of test_torch_tally's JAX step
QUORUM = 67


@pytest.fixture(scope="module")
def step():
    """One padded step: 24 votes over 4 validators (every 5th signature
    corrupted) in 64 rows; a valid row with its pre-check cleared; valid
    rows with slots -1, -5, S and S + 7; rows whose validator index is
    past the set or negative (their signatures are another validator's);
    a prior holding slots at and past quorum. Returns (the JAX packed
    output, the port's inputs per field)."""
    rng = np.random.default_rng(0xF05)
    seeds = [rng.bytes(32) for _ in range(V)]
    pubs = [host_ed.public_key_from_seed(s) for s in seeds]
    vidx = np.arange(N) % V
    msgs = [rng.bytes(30) for _ in range(N)]
    sigs = [host_ed.sign(seeds[v], m) for v, m in zip(vidx, msgs)]
    for i in range(0, N, 5):
        sigs[i] = sigs[i][:3] + bytes([sigs[i][3] ^ 4]) + sigs[i][4:]
    jepoch = jeb.EpochTables(pubs)
    batch = jeb._prepare_compact_np(msgs, sigs, vidx, jepoch)

    def pad(a):
        return np.concatenate([a, np.zeros((B - N,) + a.shape[1:], a.dtype)])

    s_n, h_n, vi, r_y, r_s, ok = (pad(x) for x in (batch.s_nibbles, batch.h_nibbles,
                                                   batch.val_idx, batch.r_y, batch.r_sign,
                                                   batch.pre_ok))
    vi = vi.astype(np.int32)
    assert ok[[1, 2, 3, 6, 8, 9, 11, 13]].all()
    ok[1] = False  # a valid signature whose pre-check failed
    # out of range, on rows signed by 2, 1 and 1: no reading of the index
    # (clamped, wrapped or clipped) names the signer
    vi[6], vi[9], vi[13] = V, V + 5, -1
    slot = np.full(B, -1, np.int32)
    slot[:N] = rng.integers(0, 12, N)
    slot[2], slot[3], slot[8], slot[11] = -5, S, S + 7, -1
    powers = np.array([10, 20, 30, 40], np.int32)
    prior = np.zeros(S, np.int32)
    prior[:12] = rng.integers(0, 40, 12)
    prior[12], prior[13], prior[20] = QUORUM, QUORUM + 9, QUORUM - 1  # at quorum before any vote
    vote = [s_n, h_n, vi, r_y, r_s, ok]
    want = np.asarray(jtally.compact_step_packed_jit()(
        *(jnp.asarray(a) for a in vote), jnp.asarray(slot), jnp.asarray(jepoch.tables),
        jnp.asarray(powers), jnp.asarray(prior), jnp.int32(QUORUM)))
    ins = {}
    for r in (25, 13):
        tables, quarters, pw = convert.epoch_from_jax(jepoch.tables, powers, fe_radix=r)
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in vote]
        ins[r] = (*t, torch.from_numpy(slot), torch.from_numpy(tables),
                  torch.from_numpy(quarters), torch.from_numpy(pw), torch.from_numpy(prior))
    return want, ins


def _width(args, wide):
    """The port's step arguments in int32, or every power and the prior
    times 2^25 in int64 (and the quorum with them)."""
    if not wide:
        return (*args, QUORUM)
    return (*args[:9], args[9].long() * SCALE, args[10].long() * SCALE, QUORUM * SCALE)


def _want(want, wide):
    """The JAX packed output as (valid, stake, maj23), stake int64 and
    scaled by 2^25 in the int64 form (the step is linear in the powers)."""
    valid, stake, maj = want[:B], want[B : B + S].astype(np.int64), want[B + S :]
    return valid, stake * SCALE if wide else stake, maj


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("fe_radix", [25, 13])
def test_compact_step_packed_matches_jax(step, fe_radix, wide):
    want, ins = step
    valid, stake, maj = _want(want, wide)
    # the case holds every edge the fused kernel must treat as the plain tally does
    assert valid.sum() > 0 and not valid[[1, 6, 9, 13]].any() and valid[[2, 3, 8, 11]].all()
    assert maj[12] and maj[13] and 0 < maj.sum() < S
    got = tally.compact_step_packed(*_width(ins[fe_radix], wide), fe_radix=fe_radix)
    assert got.dtype == torch.int32 and got.shape == (tally.packed_size(B, S, wide),)
    g_stake, g_maj = tally.packed_stake(got, B, S, wide)
    np.testing.assert_array_equal(got[:B].numpy(), valid)
    np.testing.assert_array_equal(g_stake.numpy(), stake)
    np.testing.assert_array_equal(g_maj.numpy(), maj)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("fe_radix", [25, 13])
def test_compact_step_partial_matches_jax(step, fe_radix, wide):
    """The partial form: valid at the head of the packed vector, and the
    partial stake (no prior, no compare) written into the row it is
    given, here a row of the reduce's [n, S] buffer."""
    want, ins = step
    valid, stake, _ = _want(want, wide)
    args = _width(ins[fe_radix], wide)
    buf = torch.full((2, S), -1, dtype=args[9].dtype)
    packed, part = tally.compact_step_partial(*args[:10], S, fe_radix=fe_radix, partial=buf[1])
    assert part.data_ptr() == buf[1].data_ptr() and (buf[0] == -1).all()
    np.testing.assert_array_equal(packed[:B].numpy(), valid)
    prior = args[10].numpy().astype(np.int64)
    np.testing.assert_array_equal(part.numpy(), stake - prior)
    fresh, part2 = tally.compact_step_partial(*args[:10], S, fe_radix=fe_radix)
    assert part2.dtype == args[9].dtype
    np.testing.assert_array_equal(part2.numpy(), part.numpy())
    np.testing.assert_array_equal(fresh.numpy(), packed.numpy())


MB, MN, MS = 32, 28, 8  # test_torch_mesh's sharded step


@pytest.fixture(scope="module")
def mesh_ref():
    vals, seeds = make_valset(4)
    msgs, sigs, vidx, slot = make_batch(
        vals, seeds, n_txs=7, corrupt=("ok", "flip", "ok", "wrongkey", "badidx"))
    epoch = jeb.EpochTables([v.pub_key for v in vals])
    batch = jeb.prepare_compact(msgs, sigs, vidx, epoch)

    def p(a):
        return np.concatenate([a, np.zeros((MB - MN,) + a.shape[1:], a.dtype)])

    slot = np.concatenate([np.asarray(slot, np.int32), np.full(MB - MN, -1, np.int32)])
    prior = np.zeros(MS, np.int32)
    prior[:7] = [0, 25, 0, 0, 10, 0, 0]
    powers = vals.powers_array().astype(np.int32)
    vote = [p(x) for x in (batch.s_nibbles, batch.h_nibbles, batch.val_idx, batch.r_y,
                           batch.r_sign, batch.pre_ok)] + [slot]
    quorum = int(vals.quorum_power())
    packed = np.asarray(sharded_compact_step_packed_cached(jax_make_mesh(8))(
        *vote, epoch.tables, powers, prior, np.int32(quorum))).reshape(8, -1)
    bs = MB // 8
    want = (packed[:, :bs].reshape(-1), packed[0, bs : bs + MS], packed[0, bs + MS :])
    args = {}
    for r in (25, 13):
        tables, quarters, pw = convert.epoch_from_jax(epoch.tables, powers, fe_radix=r)
        args[r] = [torch.from_numpy(np.ascontiguousarray(x)) for x in vote] + [
            torch.from_numpy(tables), torch.from_numpy(quarters), torch.from_numpy(pw),
            torch.from_numpy(prior)]
    return args, quorum, want


@pytest.fixture
def reduces(monkeypatch):
    """Count ``reduce_quorum`` calls and the psum's copies."""
    calls = {"reduce": 0}
    real = tally.reduce_quorum

    def counted(*a, **k):
        calls["reduce"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tally, "reduce_quorum", counted)
    monkeypatch.setattr(pm, "copies", {"partial": 0, "tail": 0})
    return calls


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_step_reduces_once_and_matches_jax(mesh_ref, reduces, n, wide):
    args, quorum, (valid, stake, maj) = mesh_ref
    a = list(args[25])
    if wide:
        a[9], a[10], quorum = a[9].long() * SCALE, a[10].long() * SCALE, quorum * SCALE
        stake = stake.astype(np.int64) * SCALE
    mesh = pm.make_mesh(n, device="cpu")
    parts = pm.sharded_compact_step_packed(mesh, fe_radix=25)(*a, quorum)
    assert reduces["reduce"] == 1
    # partials of shards on the first device are written in place: only
    # the reduced tail crosses, once to each other shard
    assert pm.copies == {"partial": 0, "tail": n - 1}
    bs = MB // n
    tail0 = parts[0][bs:]
    assert len(parts) == n and all(p.shape == (tally.packed_size(bs, MS, wide),) for p in parts)
    for p in parts[1:]:
        np.testing.assert_array_equal(p[bs:].numpy(), tail0.numpy())
    g_stake, g_maj = tally.packed_stake(parts[0], bs, MS, wide)
    np.testing.assert_array_equal(torch.cat([p[:bs] for p in parts]).numpy(), valid)
    np.testing.assert_array_equal(g_stake.numpy(), stake)
    np.testing.assert_array_equal(g_maj.numpy(), maj)
    assert 0 < maj.sum() < 7


def test_radix13_sharded_step_reduces_once_and_matches_jax(mesh_ref, reduces):
    args, quorum, want = mesh_ref
    mesh = pm.make_mesh(4, device="cpu")
    parts = pm.sharded_compact_step_packed(mesh, fe_radix=13)(*args[13], quorum)
    assert reduces["reduce"] == 1 and pm.copies["tail"] == 3
    host = pm.to_host(parts).numpy().reshape(4, -1)
    bs = MB // 4
    np.testing.assert_array_equal(host[:, :bs].reshape(-1), want[0])
    for sh in range(4):
        np.testing.assert_array_equal(host[sh, bs : bs + MS], want[1])
        np.testing.assert_array_equal(host[sh, bs + MS :], want[2])


def test_mesh_verifier_reduces_once_a_step(mesh_ref, reduces):
    """The engine's verifier over a 4-entry CPU mesh: one reduce per
    ``verify_and_tally``, answers equal to the JAX step's."""
    vals, seeds = make_valset(4)
    msgs, sigs, vidx, slot = make_batch(vals, seeds, n_txs=5, corrupt=("ok", "flip", "ok"))
    port = ValidatorSet([Validator.from_pub_key(v.pub_key, v.voting_power) for v in vals])
    assert [v.pub_key for v in port] == [v.pub_key for v in vals]
    prior = np.array([0, 25, 0, 0, 10])
    verifier = DeviceVoteVerifier(port, mesh=pm.make_mesh(4, device="cpu"))
    got = verifier.verify_and_tally(msgs, sigs, vidx, slot, 5, prior)
    assert reduces["reduce"] == 1 and pm.copies == {"partial": 0, "tail": 3}
    golden = ScalarVoteVerifier(port).verify_and_tally(msgs, sigs, vidx, slot, 5, prior)
    for f in ("valid", "stake", "maj23", "dropped"):
        np.testing.assert_array_equal(getattr(got, f), getattr(golden, f), err_msg=f)


@pytest.mark.parametrize("n", [2, 4])
def test_psum_without_outputs_reduces_once(reduces, n):
    """``psum_quorum`` with no output segments (the K5 composition's):
    one reduce, the partials copied into the reduce's buffer, the same
    global stake and maj23 on every shard."""
    rng = np.random.default_rng(n)
    mesh = pm.make_mesh(n, device="cpu")
    partials = [torch.from_numpy(rng.integers(0, 1 << 20, 40).astype(np.int32)) for _ in range(n)]
    prior = torch.from_numpy(rng.integers(0, 1 << 20, 40).astype(np.int32))
    want = prior.numpy().astype(np.int64) + sum(p.numpy().astype(np.int64) for p in partials)
    q = int(np.median(want))
    stakes, majs = pm.psum_quorum(mesh, partials, prior, q)
    assert reduces["reduce"] == 1 and pm.copies == {"partial": n, "tail": 0}
    for st, mj in zip(stakes, majs):
        np.testing.assert_array_equal(st.numpy(), want)
        np.testing.assert_array_equal(mj.numpy(), want >= q)


def test_ring_step_partials_come_from_the_fused_step(mesh_ref, monkeypatch):
    """The ring step keeps its ring and its reduce a shard; its partials
    come from ``compact_step_partial`` (the fused entry on a card)."""
    args, quorum, (valid, stake, maj) = mesh_ref
    calls = {"partial": 0, "reduce": 0}
    real_partial, real_reduce = tally.compact_step_partial, tally.reduce_quorum

    def partial(*a, **k):
        calls["partial"] += 1
        return real_partial(*a, **k)

    def reduce(*a, **k):
        calls["reduce"] += 1
        return real_reduce(*a, **k)

    monkeypatch.setattr(tally, "compact_step_partial", partial)
    monkeypatch.setattr(tally, "reduce_quorum", reduce)
    v, st, mj = pm.sharded_ring_step(pm.make_mesh(4, device="cpu"))(*args[25], quorum)
    assert calls == {"partial": 4, "reduce": 4}
    np.testing.assert_array_equal(pm.to_host(v).numpy(), valid.astype(bool))
    for sh in range(4):
        np.testing.assert_array_equal(st[sh].numpy(), stake)
        np.testing.assert_array_equal(mj[sh].numpy(), maj.astype(bool))


# --- the CUDA wrapper's one call, with the launch faked


@pytest.fixture
def fake_launch(monkeypatch):
    """Record ``_lib.launch`` calls instead of making them; accept CPU
    tensors where the wrapper checks for CUDA ones."""
    calls = []
    monkeypatch.setattr(_lib, "check_all", lambda *specs: None)
    monkeypatch.setattr(_lib, "launch", lambda kernel, fn, t, n, *a: calls.append((kernel, fn, n, a)))
    monkeypatch.setattr(curve, "device_base_quarters",
                        lambda dev, r=25: torch.zeros(1, dtype=torch.int32))
    return calls


@pytest.mark.parametrize("partial", [False, True], ids=["quorum", "partial"])
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("fe_radix", [25, 13])
def test_fused_wrapper_is_one_call_of_the_c_entry(fake_launch, fe_radix, wide, partial):
    """One call of ``txf_verify_tally`` (int64: ``txf_verify_tally64``),
    counted as ``verify[13]_tally[64]`` or ``verify[13]_partial[64]``,
    with as many arguments as the C entry takes before its stream; the
    quorum form passes the prior, the packed buffer's stake and maj23
    segments and a completion counter in the call's scratch (after the
    points, and after the int64 sums in the int64 form), the partial form
    the partial and none of those."""
    F = {25: fe, 13: fe13}[fe_radix]
    b, s, v = 8, 6, 3
    acc_t = torch.int64 if wide else torch.int32
    z = torch.zeros
    verify = (z(b, 64, dtype=torch.uint8), z(b, 64, dtype=torch.uint8), z(b, dtype=torch.int32),
              z(v, 16, 4, F.NLIMB, dtype=torch.int32), z(v, 3, 16, 4, F.NLIMB, dtype=torch.int32),
              z(b, 32, dtype=torch.uint8), z(b, dtype=torch.uint8), z(b, dtype=torch.bool))
    slot, powers = z(b, dtype=torch.int32), z(v, dtype=acc_t)
    packed = z(tally.packed_size(b, s, wide), dtype=torch.int32)
    pp = packed.data_ptr()
    if partial:
        part = z(s, dtype=acc_t)
        ed25519_batch.verify_tally_into(packed, *verify, slot, powers, partial=part,
                                        fe_radix=fe_radix)
    else:
        prior = z(s, dtype=acc_t)
        ed25519_batch.verify_tally_into(packed, *verify, slot, powers, prior, 7,
                                        fe_radix=fe_radix)
    (kernel, fn, n, a), = fake_launch
    assert kernel == ("verify" + F.TAG + ("_partial" if partial else "_tally")
                      + ("64" if wide else ""))
    assert _lib.KERNELS[kernel] == ("verify13" if fe_radix == 13 else "verify")
    assert fn == ("txf_verify_tally64" if wide else "txf_verify_tally")
    argtypes = _lib.LIBS[_lib.KERNELS[kernel]][2][fn]
    assert len(a) == len(argtypes) - 1 and n == b + s
    assert a[-2:] == (b, s) and a[5] == v and a[11] == pp
    points, done, maj = a[10], a[-3], a[-4]
    if partial:
        assert a[14] is None and a[15] == 0 and a[16] == part.data_ptr()
        assert all(x is None for x in a[17:-2])
    else:
        assert a[14] == prior.data_ptr() and a[15] == 7
        sw = 2 * s if wide else s
        stake = a[17] if wide else a[16]
        assert stake == pp + 4 * b and maj == pp + 4 * (b + sw)
        pts = b * 3 * F.NLIMB * 4
        if wide:
            assert a[16] == points + pts and a[16] % 8 == 0
            assert done == points + pts + 8 * s
        else:
            assert done == points + pts
