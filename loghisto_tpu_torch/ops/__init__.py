"""Device ops of the port: codec, ingest, the paged store and the window
merge (plain versions and the Hopper kernel wrappers), host fold,
statistics and dispatch.

The package-level names are the reference's codec, frame and statistics
names (``ops/codec.py``, ``ops/stats.py``).  They load on first use
(PEP 562), so importing one op module does not import the others."""

import importlib

_LAZY = {
    "compress": "codec",
    "compress_np": "codec",
    "compress_scalar": "codec",
    "decompress": "codec",
    "decompress_np": "codec",
    "decompress_scalar": "codec",
    "FrameError": "codec",
    "FrameTruncated": "codec",
    "decode_frame": "codec",
    "encode_frame": "codec",
    "iter_frames": "codec",
    "bucket_representatives": "stats",
    "dense_stats": "stats",
    "percentiles_sparse": "stats",
    "summarize_sparse": "stats",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
