"""PyTorch port, K5 over the radix-2^13 field (K8): the port's
gathered-table verify (plain version on the CPU, the operations of
``csrc/verify.cu:txf_verify_tables_kernel`` built as library
``verify13``) against the JAX package's default-radix ``verify_batch`` on
the adversarial batch of ``tests/test_torch_verify_tables.py`` (its JAX
shape, B = 27), 16 of its rows through the port (see
``test_torch_radix13.py``), and the per-vote radix-13 tables against the
JAX package's converted through ``convert.py``. Tolerance 0."""

import numpy as np
import torch

from test_torch_radix13 import ROWS, T
from test_torch_verify_tables import _batch, _with_identity_rows
from txflow_tpu.ops import ed25519_batch as jeb
from txflow_tpu_torch import convert
from txflow_tpu_torch.crypto import ed25519 as host_ed
from txflow_tpu_torch.ops import ed25519_batch as eb


def test_k5_radix13_mask_matches_jax_and_golden():
    msgs, sigs, vidx, pubs = _batch()
    jbatch = _with_identity_rows(jeb.prepare_batch(msgs, sigs, vidx, jeb.EpochTables(pubs)),
                                 lambda b: b.astype(np.int32))
    want = np.asarray(jeb.verify_batch(jbatch))
    pb = _with_identity_rows(eb.prepare_batch(msgs, sigs, vidx, eb.EpochTables(pubs, fe_radix=13)),
                             lambda b: b)
    assert pb.a_tables.shape == (27, 16, 4, 20)
    np.testing.assert_array_equal(pb.a_tables, convert.prepared_batch_from_jax(jbatch, 13).a_tables)
    # the host API over the 16 rows: verify_batch -> verify_kernel over K8
    sub = eb.PreparedBatch(*(x[ROWS] for x in (pb.s_nibbles, pb.h_nibbles, pb.a_tables, pb.r_y,
                                                pb.r_sign, pb.pre_ok)))
    got = torch.from_numpy(eb.verify_batch(sub, device="cpu", fe_radix=13))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want[ROWS])
    golden = [0 <= vidx[j] < len(pubs) and host_ed.verify_pure(pubs[vidx[j]], msgs[j], sigs[j])
              for j in ROWS[:14]] + [True, False]
    assert got.tolist() == golden
