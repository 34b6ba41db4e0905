from .g2o import load_g2o_text
from .stype import (load_graph_bytes, load_graph_file, save_graph_bytes,
                    save_graph_file)

__all__ = ["load_g2o_text", "load_graph_bytes", "load_graph_file",
           "save_graph_bytes", "save_graph_file"]
