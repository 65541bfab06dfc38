"""io subpackage of rome_tpu_torch: g2o dataset I/O + graph serialization."""

from rome_tpu_torch.io.g2o import export_g2o, import_g2o, load_g2o, parse_g2o_instruction
from rome_tpu_torch.io.serialization import (
    load_dfg,
    loadDFG,
    pack_distribution,
    pack_factor,
    pack_manifold,
    save_dfg,
    saveDFG,
    unpack_distribution,
    unpack_factor,
    unpack_manifold,
)

__all__ = [
    "import_g2o",
    "export_g2o",
    "load_g2o",
    "parse_g2o_instruction",
    "save_dfg",
    "load_dfg",
    "saveDFG",
    "loadDFG",
    "pack_distribution",
    "unpack_distribution",
    "pack_factor",
    "unpack_factor",
    "pack_manifold",
    "unpack_manifold",
]
