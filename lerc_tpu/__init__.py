"""lerc_tpu: a JAX-native LERC (Limited Error Raster Compression) engine.

Built from scratch in JAX/XLA with full wire compatibility with the
reference Esri/lerc C++ library (codec Lerc1 and Lerc2 v1-v6).

The numpy-facing API mirrors the reference `lerc` Python package:
encode / encode_4D / encode_ma, decode / decode_4D / decode_ma,
getLercBlobInfo[_4D], getLercDataRanges, plus pythonic compress/decompress.
"""

from .api import (
    compress,
    computeCompressedSize,
    computeCompressedSize_4D,
    computeCompressedSizeForVersion,
    convert2ma,
    decode,
    decode_4D,
    decode_ma,
    decodeToDouble,
    decodeToDouble_4D,
    decompress,
    encode,
    encode_4D,
    encode_ma,
    encodeForVersion,
    findDataRange,
    findDataRange_ma,
    findMaxZError,
    findMaxZError_4D,
    findMaxZError_ma,
    getLercBlobInfo,
    getLercBlobInfo_4D,
    getLercDataRanges,
    getLercDatatype,
    getLercShape,
)
from .codec.encode_orchestrator import set_acceleration
from .constants import DataType, ErrCode

__version__ = "0.10.0"
