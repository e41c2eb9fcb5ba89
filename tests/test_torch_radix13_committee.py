"""PyTorch port, committee certificates over the radix-2^13 field (K8,
K6's path): ``BatchCertVerifier(fe_radix=13)`` (device="cpu", the plain
radix-13 verify kernel) against the JAX package's default-radix
``BatchCertVerifier`` on the cases of ``tests/test_torch_committee.py``
at its rung 16 over V = 4: valid, stake, maj23, dropped and the
counters equal (tolerance 0), with a prior and a quorum override; a
restage into another committee keeps the field."""

import numpy as np
import pytest

import txflow_tpu.committee as jcom

import txflow_tpu_torch.committee as pcom
from test_torch_committee import CASES, _assert_same, _batch, _counters, _random_spec, _sets
from txflow_tpu_torch.committee.certverify import _rung

RUNG16 = {
    "spec": CASES["spec"],  # 9 rows: repeats, a corrupted S, four slots
    "byzantine": ("random", 12, 5),
}


@pytest.mark.parametrize("case", sorted(RUNG16))
def test_radix13_batch_cert_verifier_matches_jax(case):
    pvs, jvals, pvals = _sets(4, [10] * 4, b"bcv")
    spec = RUNG16[case]
    if spec[0] == "random":
        spec = _random_spec(np.random.default_rng(1313), spec[1], 4, spec[2])
    batch = _batch(pvs, jvals, spec)
    assert _rung(len(batch[0])) == 16
    jv = jcom.BatchCertVerifier(jvals, min_batch=4)
    pv = pcom.BatchCertVerifier(pvals, min_batch=4, device="cpu", fe_radix=13)
    assert pv._stage[4].shape == (4, 16, 4, 20)
    prior = np.arange(batch[4], dtype=np.int64) * 3
    got = pv.verify_and_tally(*batch, quorum=20, prior_stake=prior)
    _assert_same(got, jv.verify_and_tally(*batch, quorum=20, prior_stake=prior))
    assert _counters(pv) == _counters(jv) == (1, 0, len(batch[0]))
    assert 0 < got.valid.sum() < len(batch[0]) and 0 < got.maj23.sum() < batch[4]
    _sets8 = _sets(8, [10] * 8, b"bcv8")[2]
    assert pv.restage(pcom.sample_committee(_sets8, "c", 1, 4)) and pv.fe_radix == 13
    assert pv._stage[4].shape[-1] == 20
