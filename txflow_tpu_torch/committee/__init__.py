"""Committee certificates: per-epoch committee sampling and the batched
certificate verifier (one K6 launch per certificate batch)."""

from .certverify import BatchCertVerifier
from .sampler import SEED_DOMAIN, CommitteeSchedule, committee_seed, sample_committee

__all__ = [
    "BatchCertVerifier",
    "CommitteeSchedule",
    "SEED_DOMAIN",
    "committee_seed",
    "sample_committee",
]
