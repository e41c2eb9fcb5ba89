"""Domain-separation tags for the port's seeded hash streams (the one
``txflow_tpu/utils/domains.py`` tag the committee sampler needs; the
registry and its lint are not copied)."""

# Per-epoch committee sampling (committee/sampler.py): versioned so a
# future sampler change cannot silently elect a different committee for
# the same (chain_id, epoch). Wire surface: every node must derive it.
COMMITTEE_V1 = b"txflow/committee/v1"
