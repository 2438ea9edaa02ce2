from slamrs_tpu_torch.viz.shapes import (Camera, Color,  # noqa: F401
                                         PrimitiveType, ShapeRenderer)
