from .pipeline import (
    DataConfig,
    FileTokenSource,
    SyntheticMarkovSource,
    TokenBatcher,
    make_source,
)

__all__ = [
    "DataConfig",
    "FileTokenSource",
    "SyntheticMarkovSource",
    "TokenBatcher",
    "make_source",
]
