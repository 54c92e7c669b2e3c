"""Mesh, GLB, FBX, Alembic, PNG and video I/O on the host (numpy; cv2 and
PIL imported lazily, where a function needs them)."""

from motion324_tpu_torch.io.mesh import (  # noqa: F401
    TriMesh,
    load_mesh,
    normalize_unit_cube,
    sample_surface,
    sample_with_albedo,
)
from motion324_tpu_torch.io.glb import (  # noqa: F401
    load_glb,
    load_animated_glb,
    export_animated_glb,
    export_glb,
)
from motion324_tpu_torch.io.fbx import export_animated_fbx, load_fbx  # noqa: F401
from motion324_tpu_torch.io.abc import export_animated_abc, read_abc  # noqa: F401
from motion324_tpu_torch.io.png import decode_png, encode_png  # noqa: F401
from motion324_tpu_torch.io.video import read_video, write_video  # noqa: F401
