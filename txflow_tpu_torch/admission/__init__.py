"""Admission lanes (``txflow_tpu/admission/``): the fee-prefix lane
classifier a node hands to its mempool (``Mempool.lane_of``), whose verdict
the vote pool reads through ``TxVotePool.lane_of_vote``.

Only the classifier is ported here; the admission controller and its
config (edge dedup, overload backpressure) come with the node services.
"""

from .classifier import FeeLaneClassifier, parse_fee, parse_sender

__all__ = ["FeeLaneClassifier", "parse_fee", "parse_sender"]
