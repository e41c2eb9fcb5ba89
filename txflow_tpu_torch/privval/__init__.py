"""Key management: a file signer with last-sign state and a remote signer
socket for tx votes (counterpart of ``txflow_tpu/privval/``)."""

from .file import ErrDoubleSign, FilePV
from .signer import RemoteSignerError, SignerClient, SignerServer

__all__ = [
    "ErrDoubleSign",
    "FilePV",
    "RemoteSignerError",
    "SignerClient",
    "SignerServer",
]
