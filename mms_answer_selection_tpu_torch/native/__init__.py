from .packed_format import (  # noqa: F401
    NativePrefetcher,
    PackedStore,
    native_shuffle,
    write_mmsp,
)
