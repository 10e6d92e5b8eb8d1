"""Bitstream (layer L4): the `.ecdc` container and LSB-first bit packing."""

from .binary import (  # noqa: F401
    BitPacker,
    BitUnpacker,
    pack_bits,
    unpack_bits,
    write_ecdc_header,
    read_ecdc_header,
)
from .compress import (  # noqa: F401
    compress,
    decompress,
    compress_to_file,
    decompress_from_file,
)
