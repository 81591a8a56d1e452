"""Distributed execution substrate of the port.

* ``mesh``        — named axes over the ranks of a process group, one
                    gloo group per axis;
* ``sharding``    — logical-axis -> mesh-axis rule tables, PDef-tree ->
                    resolved-spec resolution, a leaf's placement on a
                    mesh (``local_shape``, ``shard``, ``gather``), and the
                    ``submesh_for`` bridge from a Flux ``ResourceSet``
                    allocation to a mesh over this process's devices;
* ``actsharding`` — the ``activation_sharding(mesh, strategy)`` context
                    the model code reads to place its work on a mesh of
                    ranks (``constrain`` is the identity);
* ``steps``       — the train step and train-state init/abstract
                    schemas, consumed by the trainer and the executors.
"""
from repro_torch.dist import actsharding, sharding  # noqa: F401
from repro_torch.dist.actsharding import (  # noqa: F401
    activation_sharding, constrain, model_axis_divides,
)
from repro_torch.dist.mesh import make_mesh  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    param_rules, replicated, resolve_spec, submesh_for,
)


def __getattr__(name):
    # ``steps`` imports the model facade; loading it lazily keeps the
    # models -> dist import chain acyclic.
    if name == "steps":
        import importlib
        return importlib.import_module("repro_torch.dist.steps")
    raise AttributeError(name)
