"""PyTorch port, the quarter tables of the four-lane verify kernel
(``EpochTables.quarter_tables``, ``curve.BASE_QUARTER_TABLES``): entry
[j, k] of a point's quarter tables equals the JAX package's
``txflow_tpu/ops/curve.py:build_pniels_table`` of 2^(64j) times the point,
computed with the JAX package's host point arithmetic and carried into
the port's limbs by ``convert.py``, in both fields, an off-curve key
(identity tables) and the zero key included; quarter 0 is the one-table
build of today's ``tables``, bit for bit; and ``convert.epoch_from_jax``
derives the same quarter tables from the JAX tables alone. Tolerance 0
(integer limbs)."""

import numpy as np
import pytest
import torch

from txflow_tpu.crypto import ed25519 as jed
from txflow_tpu.ops import curve as jcurve
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import curve
from txflow_tpu_torch.ops import ed25519_batch as eb

BAD_PUB = (2).to_bytes(32, "little")  # y = 2 is off the curve
RNG = np.random.default_rng(0x9A27)
PUBS = [host_ed.public_key_from_seed(RNG.bytes(32)) for _ in range(3)] + [BAD_PUB, bytes(32)]


def _jax_quarters(pt) -> np.ndarray:
    """[4, 16, 4, 32]: JAX window tables of 2^(64j) * pt, j = 0..3, by the
    JAX package's host doubling."""
    out = []
    for j in range(4):
        out.append(jcurve.build_pniels_table(pt))
        for _ in range(64):
            pt = jed.point_double(pt)
    return np.stack(out)


def _jax_neg_key_quarters(pub: bytes) -> np.ndarray:
    A = jed.point_decompress(pub)
    return _jax_quarters(jed.IDENTITY if A is None else jed.point_neg(A))


@pytest.fixture(scope="module")
def jax_quarters():
    return np.stack([_jax_neg_key_quarters(pk) for pk in PUBS])  # [V, 4, 16, 4, 32]


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_epoch_quarter_tables_match_jax(jax_quarters, fe_radix):
    epoch = eb.EpochTables(PUBS, fe_radix=fe_radix)
    nlimb = 10 if fe_radix == 25 else 20
    assert epoch.quarter_tables.shape == (len(PUBS), 3, 16, 4, nlimb)
    assert epoch.quarter_tables.dtype == np.int32 and epoch.quarter_tables.flags.c_contiguous
    want = convert.limbs8_to_limbs(jax_quarters, fe_radix)
    np.testing.assert_array_equal(epoch.tables, want[:, 0])
    np.testing.assert_array_equal(epoch.quarter_tables, want[:, 1:])
    # the off-curve key: identity tables in every quarter, and key_ok False
    ident = convert.limbs8_to_limbs(jcurve.build_pniels_table(jed.IDENTITY), fe_radix)
    assert (epoch.quarter_tables[3] == ident).all() and epoch.key_ok.tolist() == [
        True, True, True, False, True]


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_base_quarter_tables_match_jax(fe_radix):
    want = convert.limbs8_to_limbs(_jax_quarters(jed.BASE), fe_radix)
    np.testing.assert_array_equal(curve.BASE_QUARTER_TABLES[fe_radix], want)
    np.testing.assert_array_equal(curve.BASE_TABLES[fe_radix], want[0])
    got = curve.device_base_quarters("cpu", fe_radix)
    assert got is curve.device_base_quarters(torch.device("cpu"), fe_radix)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_quarter_zero_is_the_one_table_build(fe_radix):
    """The batched build (one inversion for every entry of every key)
    leaves quarter 0 exactly as the per-entry build of one table
    (``build_pniels_table``, one inversion an entry) makes it, and a
    repeated key gets the same rows."""
    pubs = PUBS + [PUBS[0], BAD_PUB]
    epoch = eb.EpochTables(pubs, fe_radix=fe_radix)
    one = np.stack([curve.build_pniels_table(eb.neg_pubkey_point(pk)[0], fe_radix) for pk in pubs])
    np.testing.assert_array_equal(epoch.tables, one)
    np.testing.assert_array_equal(epoch.quarter_tables[5], epoch.quarter_tables[0])
    np.testing.assert_array_equal(curve.BASE_TABLES[fe_radix],
                                  curve.build_pniels_table(host_ed.BASE, fe_radix))


@pytest.mark.parametrize("fe_radix", [25, 13])
def test_epoch_from_jax_derives_the_port_quarter_tables(fe_radix):
    jepoch = jeb.EpochTables(PUBS)
    tables, quarters, powers = convert.epoch_from_jax(np.asarray(jepoch.tables),
                                                      np.arange(1, 6) * 10, fe_radix)
    own = eb.EpochTables(PUBS, fe_radix=fe_radix)
    np.testing.assert_array_equal(tables, own.tables)
    np.testing.assert_array_equal(quarters, own.quarter_tables)
    assert powers.dtype == np.int32 and powers.tolist() == [10, 20, 30, 40, 50]
    empty = convert.quarter_tables_from_jax(np.zeros((0, 16, 4, 32), np.int32), fe_radix)
    assert empty.shape == (0, 3, 16, 4, 10 if fe_radix == 25 else 20)


def test_device_quarter_tables_upload_once_per_device():
    epoch = eb.EpochTables(PUBS[:2])
    q = epoch.device_quarter_tables("cpu")
    assert q is epoch.device_quarter_tables(torch.device("cpu"))
    assert q.dtype == torch.int32 and q.shape == (2, 3, 16, 4, 10) and q.is_contiguous()
    np.testing.assert_array_equal(q.numpy(), epoch.quarter_tables)
    empty = eb.EpochTables([])
    assert empty.tables.shape == (0, 16, 4, 10) and empty.quarter_tables.shape == (0, 3, 16, 4, 10)
