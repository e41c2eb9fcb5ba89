"""PyTorch port, K8 under the curve and verify code: the port's verify
kernels over the radix-2^13 field (plain versions on the CPU, the
operations of ``csrc/verify.cu`` built as library ``verify13``) against
the JAX package's verify masks, and how an object picks its field.

A verify mask does not depend on the field's representation, and
``tests/test_fe13.py`` already holds the JAX package's radix-13 kernel to
its radix-8 one; so the port's radix-13 K3 mask is held, in process, to
JAX's default-radix ``compact_step_packed`` on the adversarial batch of
``tests/test_torch_verify_tables.py`` (a JAX shape the port's other tests
compile: B = 64 over V = 8; K5 is ``test_torch_radix13_tables.py``), 16
of its rows through the port: honest votes, flipped R and S bytes, a wrong message, a wrong key,
S >= L, a short signature, an off-curve key, a flipped sign bit, and
R = 1 against the non-canonical R = p + 1. Tolerance 0. No test sets
``TXFLOW_FE_RADIX`` in ``os.environ`` or reloads a module: the field is
passed as ``fe_radix``, and the environment's choice is shown with
``monkeypatch.setenv`` around object construction."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_verify_tables import _batch, _with_identity_rows
from txflow_tpu.ops import curve as jcurve
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu.ops import tally as jtally
from txflow_tpu_torch import convert
from txflow_tpu_torch.committee import BatchCertVerifier
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.engine import TxExecutor, TxFlow
from txflow_tpu_torch.ops import curve, fe, fe13, field
from txflow_tpu_torch.ops import ed25519_batch as eb
from txflow_tpu_torch.parallel import make_mesh
from txflow_tpu_torch.pool import Mempool, TxVotePool
from txflow_tpu_torch.store import MemDB, TxStore
from txflow_tpu_torch.sync import SyncManager
from txflow_tpu_torch.types import Validator, ValidatorSet
from txflow_tpu_torch.utils.config import EngineConfig, MempoolConfig
from txflow_tpu_torch.verifier import DeviceVoteVerifier

# the batch's 14 classified rows (6 honest, then flipped R, flipped S,
# wrong message, wrong key, S >= L, short, off-curve, sign bit) and its
# two identity rows (R = 1, R = p + 1): 16 signatures through the port
ROWS = list(range(14)) + [25, 26]


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def ref():
    """The JAX K3 mask of the whole batch, through the fused step (the 7
    keys padded to 8 with a zero key, 64 rows)."""
    msgs, sigs, vidx, pubs = _batch()
    assert len(msgs) == 27
    jepoch = jeb.EpochTables(pubs + [bytes(32)])
    jc = _with_identity_rows(jeb._prepare_compact_np(msgs, sigs, vidx, jepoch),
                             lambda b: b.astype(np.uint8))
    args = [np.concatenate([x, np.zeros((64 - 27,) + x.shape[1:], x.dtype)])
            for x in (jc.s_nibbles, jc.h_nibbles, jc.val_idx, jc.r_y, jc.r_sign, jc.pre_ok)]
    packed = jtally.compact_step_packed_jit()(
        *(jnp.asarray(a) for a in args), jnp.full(64, -1, jnp.int32), jnp.asarray(jepoch.tables),
        jnp.ones(8, jnp.int32), jnp.zeros(64, jnp.int32), jnp.int32(1),
    )
    k3 = np.asarray(packed)[:27].astype(bool)
    return msgs, sigs, vidx, pubs, jepoch, k3


def test_radix13_tables_are_the_jax_tables_converted(ref):
    _msgs, _sigs, _vidx, pubs, jepoch, _k3 = ref
    epoch = eb.EpochTables(pubs + [bytes(32)], fe_radix=13)
    tables, _ = convert.epoch_from_jax(jepoch.tables, np.ones(8), fe_radix=13)
    assert epoch.fe_radix == 13 and tables.shape == (8, 16, 4, 20)
    np.testing.assert_array_equal(epoch.tables, tables)
    np.testing.assert_array_equal(
        curve.BASE_TABLES[13], convert.base_table_from_jax(np.asarray(jcurve.BASE_TABLE), fe_radix=13))


def test_k3_radix13_mask_matches_jax_and_golden(ref):
    msgs, sigs, vidx, pubs, _jepoch, k3 = ref
    epoch = eb.EpochTables(pubs + [bytes(32)], fe_radix=13)
    c = _with_identity_rows(eb.prepare_compact(msgs, sigs, vidx, epoch), lambda b: b)
    args = [T(x[ROWS]) for x in (c.s_nibbles, c.h_nibbles, c.val_idx)] + [T(epoch.tables)] + [
        T(x[ROWS]) for x in (c.r_y, c.r_sign, c.pre_ok)]
    got = eb.verify_kernel_gather(*args, fe_radix=13).numpy()
    np.testing.assert_array_equal(got, k3[ROWS])
    golden = [0 <= vidx[j] < len(pubs) and host_ed.verify_pure(pubs[vidx[j]], msgs[j], sigs[j])
              for j in ROWS[:14]] + [True, False]
    assert got.tolist() == golden and 0 < sum(golden) < len(ROWS)


def test_dsm_encode_radix13_equals_radix25():
    """encode([s]B + [h](-A)) over both fields: the frozen y are the same
    32 bytes and the parities equal (8 seeded scalar pairs, V = 4)."""
    rng = np.random.default_rng(13)
    pubs = [host_ed.public_key_from_seed(rng.bytes(32)) for _ in range(4)]
    s_nib = T(rng.integers(0, 16, (8, 64), dtype=np.uint8))
    h_nib = T(rng.integers(0, 16, (8, 64), dtype=np.uint8))
    vidx = T(rng.integers(0, 4, 8).astype(np.int32))
    out = {}
    for r in (25, 13):
        y, parity = curve.dsm_encode(s_nib, h_nib, vidx, T(eb.EpochTables(pubs, fe_radix=r).tables),
                                     fe_radix=r)
        assert y.shape == (8, field.ops(r).NLIMB) and y.dtype == torch.int32
        out[r] = (field.ops(r).frozen_to_bytes(y.numpy()), parity.numpy())
    np.testing.assert_array_equal(out[13][0], out[25][0])
    np.testing.assert_array_equal(out[13][1], out[25][1])
    assert 0 < out[13][1].sum() < 8


def _vals(n=4, power=10):
    rng = np.random.default_rng(404)
    return ValidatorSet([Validator.from_pub_key(host_ed.public_key_from_seed(rng.bytes(32)), power)
                         for _ in range(n)])


def _flow(vals, config):
    mempool = Mempool(MempoolConfig(cache_size=100))
    return TxFlow("txflow-radix", 1, vals, TxVotePool(MempoolConfig(cache_size=100)), mempool,
                  Mempool(MempoolConfig(cache_size=100)), TxExecutor(None, mempool),
                  TxStore(MemDB()), config=config)


@pytest.mark.parametrize("env,want", [(None, 25), ("8", 25), ("13", 13)])
def test_fe_radix_none_reads_the_environment_when_built(monkeypatch, env, want):
    """None resolves when each object (tables, verifiers on one device and
    on a mesh, the certificate verifier, the sync client, the engine's
    verifier) is built, with no module reload; an object keeps its field
    when the variable changes afterwards, and so does every rotation."""
    if env is None:
        monkeypatch.delenv(field.ENV, raising=False)
    else:
        monkeypatch.setenv(field.ENV, env)
    vals = _vals()
    objs = [
        eb.EpochTables([v.pub_key for v in vals]),
        DeviceVoteVerifier(vals, device="cpu"),
        DeviceVoteVerifier(vals, mesh=make_mesh(2, device="cpu")),
        BatchCertVerifier(vals, device="cpu"),
    ]
    flow = _flow(vals, EngineConfig(device="cpu"))
    objs.append(SyncManager("txflow-radix", TxStore(MemDB()), flow, device="cpu"))
    assert [o.fe_radix for o in objs] + [flow.verifier.fe_radix] == [want] * 6
    assert objs[0].tables.shape[-1] == field.ops(want).NLIMB
    assert objs[1].epoch.tables.shape[-1] == field.ops(want).NLIMB
    other = "8" if want == 13 else "13"
    monkeypatch.setenv(field.ENV, other)  # later changes touch no built object
    bigger = _vals(6)
    flow.update_state(2, bigger)  # past capacity 4: a new verifier, the same field
    assert flow.last_rotation["restaged"] is False and flow.verifier.fe_radix == want
    assert flow.verifier.epoch.tables.shape[-1] == field.ops(want).NLIMB
    assert objs[1].restage(_vals(3)) and objs[1].fe_radix == want
    assert objs[3].restage(bigger) and objs[3]._stage[4].shape[-1] == field.ops(want).NLIMB


def test_fe_radix_explicit_and_invalid(monkeypatch):
    monkeypatch.setenv(field.ENV, "13")
    assert DeviceVoteVerifier(_vals(), device="cpu", fe_radix=25).fe_radix == 25
    assert field.resolve(13) == 13 and field.ops(13) is fe13 and field.ops(25) is fe
    for bad in ("25", "16", ""):
        monkeypatch.setenv(field.ENV, bad)
        with pytest.raises(ValueError, match="TXFLOW_FE_RADIX"):
            DeviceVoteVerifier(_vals(), device="cpu")
    with pytest.raises(ValueError, match="fe_radix"):
        eb.EpochTables([], fe_radix=8)
    monkeypatch.delenv(field.ENV)
    assert EngineConfig().fe_radix is None
