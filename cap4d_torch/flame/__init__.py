from cap4d_torch.flame.camera import (
    OPENCV2PYTORCH3D,
    project_vertices,
    rodrigues,
    transform_vertices,
)
from cap4d_torch.flame.compute import compute_flame, load_cap4d_flame_model
from cap4d_torch.flame.io import load_flame_pkl, make_synthetic_flame, save_flame_pkl
from cap4d_torch.flame.skinner import (
    FlameModel,
    build_flame_model,
    flame_forward,
    generate_uv_half_sphere,
    mouth_sphere,
)
