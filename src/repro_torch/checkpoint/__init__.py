from .manager import read_manifest, save_pytree

__all__ = ["read_manifest", "save_pytree"]
