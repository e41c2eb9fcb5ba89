from .amino import (
    TYP3_8BYTE,
    TYP3_BYTELEN,
    TYP3_VARINT,
    encode_time_body,
    field_key,
    length_prefixed,
    read_uvarint,
    uvarint,
    varint,
)

__all__ = [
    "TYP3_8BYTE",
    "TYP3_BYTELEN",
    "TYP3_VARINT",
    "encode_time_body",
    "field_key",
    "length_prefixed",
    "read_uvarint",
    "uvarint",
    "varint",
]
