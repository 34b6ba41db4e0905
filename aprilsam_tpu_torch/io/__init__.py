from .g2o import load_g2o_text

__all__ = ["load_g2o_text"]
