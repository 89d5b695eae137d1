from .manager import read_manifest

__all__ = ["read_manifest"]
