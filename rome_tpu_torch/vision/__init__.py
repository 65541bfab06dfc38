"""vision subpackage of rome_tpu_torch: camera models and projection factors."""

from rome_tpu_torch.vision.camera import (
    CameraCalibration,
    CameraExtrinsic,
    CameraIntrinsic,
    CameraModelFull,
    GenericProjection,
    camera_residual,
    project,
    solve_multiview_landmark,
    solveMultiviewLandmark,
)

__all__ = [
    "CameraCalibration",
    "CameraIntrinsic",
    "CameraExtrinsic",
    "CameraModelFull",
    "GenericProjection",
    "project",
    "camera_residual",
    "solve_multiview_landmark",
    "solveMultiviewLandmark",
]
