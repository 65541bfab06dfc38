from rome_tpu_torch.io.g2o import export_g2o, import_g2o, load_g2o, parse_g2o_instruction

__all__ = ["import_g2o", "export_g2o", "load_g2o", "parse_g2o_instruction"]
