from .manager import CheckpointManager, load_pytree, read_manifest, save_pytree

__all__ = ["CheckpointManager", "load_pytree", "read_manifest", "save_pytree"]
