"""Runtime (port of ``repro/runtime``): the train step and the placement
of a train state (``steps``, one device or a mesh), gradient compression
across pods (``compression``), the sharding rules and placement
(``sharding``) and the mesh collectives (``collectives``). The train
step's names load on first use, so the model code can import
``collectives`` without the training stack."""

_STEPS = ("TrainRunConfig", "abstract_train_state", "gather_train_state", "init_train_state",
          "make_train_step", "mesh_train_bytes", "place_train_state", "train_state_shardings")


def __getattr__(name):
    if name in _STEPS:
        from . import steps

        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_STEPS)
