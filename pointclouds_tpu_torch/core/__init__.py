"""core modules of the PyTorch port."""

from .view import (  # noqa: F401
    CloudView,
    HasColor,
    HasIntensity,
    HasNormal,
    HasPosition,
    PointXYZ,
    PointXYZI,
    PointXYZNormal,
    PointXYZRGB,
)
