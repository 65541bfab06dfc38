"""services subpackage of rome_tpu_torch: scalar fields (DEM level-set
localization and terrain mesh graphs). The analysis helpers of the JAX
package's ``services`` are not ported yet (ROADMAP slice E)."""

from rome_tpu_torch.services.scalar_fields import (
    LevelSetGridNormal,
    PartialPriorPassThrough,
    build_graph_scalar_field,
    dem_interp,
    generate_field_canyon_dem,
    load_dem_image,
)

__all__ = [
    "LevelSetGridNormal",
    "PartialPriorPassThrough",
    "build_graph_scalar_field",
    "dem_interp",
    "generate_field_canyon_dem",
    "load_dem_image",
]
