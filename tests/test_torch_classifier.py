"""PyTorch port, admission lanes: ``parse_fee``, ``parse_sender`` and
``FeeLaneClassifier`` of txflow_tpu_torch/admission against the JAX
package's (txflow_tpu/admission/classifier.py) on fixed cases (those of
tests/test_overload.py:32 among them), seeded random prefixes and hostile
byte strings. Outputs are ints and strings: equality, tolerance 0."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from txflow_tpu.admission.classifier import FeeLaneClassifier as JFeeLaneClassifier
from txflow_tpu.admission.classifier import parse_fee as jparse_fee
from txflow_tpu.admission.classifier import parse_sender as jparse_sender
from txflow_tpu.pool.mempool import LANE_BULK as J_BULK
from txflow_tpu.pool.mempool import LANE_PRIORITY as J_PRIORITY

from txflow_tpu_torch.admission import FeeLaneClassifier, parse_fee, parse_sender
from txflow_tpu_torch.admission import classifier as pclassifier
from txflow_tpu_torch.pool import LANE_BULK, LANE_PRIORITY

FIXED = [
    b"fee=7;k=v", b"k=v", b"fee=;k=v", b"fee=nope;k=v", b"fee=1" + b"x" * 100,
    b"fee=3;k=v", b"fee=2;k=v", b"", b"fee=", b"fee=0;x", b"fee=-4;x", b"fee= 9;x",
    b"fee=+5;x", b"fee=1_000;x", b"fee=99999999999999999;x", b"fee=999999999999999999;x",
    b"FEE=5;x", b"xfee=5;x", b"fee=5;from=alice;k=v", b"from=bob;k=v", b"from=;k=v",
    b"from=\xff\xfe;k=v", b"k=v;from=carol;", b"x" * 90 + b"from=dave;", b"x" * 92 + b"from=e;",
    b"from=" + b"z" * 200 + b";", b"fee=\xd9\xa3;x", b"fee=\xef\xbc\x93;x", b"fee=3\n;x",
]


def test_lane_constants_match_jax():
    assert (LANE_PRIORITY, LANE_BULK) == (J_PRIORITY, J_BULK)
    assert pclassifier._FEE_SCAN_LIMIT == 24 and pclassifier._SENDER_SCAN_LIMIT == 96


@pytest.mark.parametrize("tx", FIXED)
def test_fixed_cases_match_jax(tx):
    assert parse_fee(tx) == jparse_fee(tx)
    assert parse_sender(tx) == jparse_sender(tx)
    for threshold in (0, 1, 3, 8):
        assert FeeLaneClassifier(threshold)(tx) == JFeeLaneClassifier(threshold)(tx)


def test_overload_cases():
    """The JAX package's own expectations (tests/test_overload.py:32)."""
    assert parse_fee(b"fee=7;k=v") == 7
    assert parse_fee(b"k=v") == 0
    assert parse_fee(b"fee=;k=v") == 0
    assert parse_fee(b"fee=nope;k=v") == 0
    assert parse_fee(b"fee=1" + b"x" * 100) == 0  # no terminator in the scan range
    clf = FeeLaneClassifier(priority_fee_threshold=3)
    assert clf(b"fee=3;k=v") == LANE_PRIORITY
    assert clf(b"fee=2;k=v") == LANE_BULK
    assert clf(b"k=v") == LANE_BULK


def test_megabyte_tx_classifies_as_jax():
    """A hostile megabyte tx that starts with ``fee=``: the bounded scans
    give the JAX package's answers (bulk, no sender)."""
    rng = np.random.default_rng(5)
    body = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes().replace(b";", b"x")
    for tx in (b"fee=" + body, b"fee=12" + body, b"fee=12;" + body, b"from=" + body):
        assert parse_fee(tx) == jparse_fee(tx)
        assert parse_sender(tx) == jparse_sender(tx)
        assert FeeLaneClassifier(1)(tx) == JFeeLaneClassifier(1)(tx)


def test_seeded_prefixes_match_jax():
    rng = np.random.default_rng(11)
    alphabet = b"0123456789;=fexrom-+ _\x00\xff"
    for _ in range(2000):
        head = rng.choice([b"fee=", b"from=", b"fee=1;from=", b"", b"fe", b"x"])
        n = int(rng.integers(0, 40))
        tail = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        tx = head + tail
        assert parse_fee(tx) == jparse_fee(tx), tx
        assert parse_sender(tx) == jparse_sender(tx), tx
        assert FeeLaneClassifier(2)(tx) == JFeeLaneClassifier(2)(tx), tx


_fee_tx = st.builds(
    lambda fee, sep, sender, payload: b"fee=" + fee + sep + sender + payload,
    st.one_of(st.integers(-10**20, 10**20).map(lambda i: str(i).encode()),
              st.binary(max_size=30)),
    st.sampled_from([b";", b"", b";;", b"=;"]),
    st.one_of(st.just(b""), st.binary(max_size=12).map(lambda b: b"from=" + b + b";")),
    st.binary(max_size=200),
)


@settings(max_examples=300, deadline=None)
@given(tx=st.one_of(_fee_tx, st.binary(max_size=300)), threshold=st.integers(-2, 50))
def test_hypothesis_prefixed_and_hostile_bytes_match_jax(tx, threshold):
    assert parse_fee(tx) == jparse_fee(tx)
    assert parse_sender(tx) == jparse_sender(tx)
    assert FeeLaneClassifier(threshold)(tx) == JFeeLaneClassifier(threshold)(tx)
