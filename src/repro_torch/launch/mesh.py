"""Test meshes over a process group (port of ``repro.launch.mesh``).

``make_test_mesh`` lays the ranks of the default process group (made
first, by ``torch.distributed.init_process_group`` or
``compat.make_process_mesh``) out as the reference's small CI mesh;
``batch_axes`` names the axes a batch is split over. The reference's
``make_production_mesh`` and ``HW`` describe a TPU pod and have no
counterpart.
"""
from __future__ import annotations

from repro_torch.compat import ProcessGroupMesh


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, *,
                   group=None, device=None) -> ProcessGroupMesh:
    """``(data, model)``, or ``(pod, data, model)`` when ``pod``, over the
    ranks of ``group`` (the default group unless given), whose size must
    be the mesh's."""
    if pod:
        return ProcessGroupMesh((pod, data, model), ("pod", "data", "model"),
                                group, device)
    return ProcessGroupMesh((data, model), ("data", "model"), group, device)


def batch_axes(mesh) -> tuple[str, ...]:
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)
