"""The port's two GF(2^255-19) fields and how an object picks one.

``fe_radix=25`` names the radix-2^25.5 field (``ops/fe.py``, K1's
counterpart, the default) and ``fe_radix=13`` the radix-2^13 field
(``ops/fe13.py``, K8). The JAX package swaps its field for the whole
process when it is imported (``TXFLOW_FE_RADIX=13``); the port holds no
such state: each verifier, table set and sharded step takes ``fe_radix``
when it is built and passes it down, and every curve and verify function
takes it as an argument. ``None`` reads ``TXFLOW_FE_RADIX`` at that moment
(``resolve``), never at import.
"""

from __future__ import annotations

import os

from . import fe, fe13

ENV = "TXFLOW_FE_RADIX"
FIELDS = {fe.FE_RADIX: fe, fe13.FE_RADIX: fe13}


def resolve(fe_radix: int | None = None) -> int:
    """The field an object is built over: ``fe_radix`` itself (25 or 13),
    or for None the environment's choice now -- ``"13"`` gives 13, unset
    or ``"8"`` (the JAX package's default field) gives 25. Anything else
    raises."""
    if fe_radix is None:
        env = os.environ.get(ENV)
        if env is None or env == "8":
            return fe.FE_RADIX
        if env == "13":
            return fe13.FE_RADIX
        raise ValueError(f"{ENV}={env!r}: expected 13 or 8 (or unset)")
    if fe_radix not in FIELDS:
        raise ValueError(f"fe_radix={fe_radix!r}: expected 25, 13 or None")
    return int(fe_radix)


def ops(fe_radix: int):
    """The field's module (its limb layout, plain arithmetic and kernel
    tag) for a resolved ``fe_radix``."""
    try:
        return FIELDS[fe_radix]
    except KeyError:
        raise ValueError(f"fe_radix={fe_radix!r}: expected 25 or 13") from None
