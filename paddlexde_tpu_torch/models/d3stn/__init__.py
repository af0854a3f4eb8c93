from .config import D3STNConfig, load_config  # noqa: F401
from .graph import (  # noqa: F401
    get_adjacency_matrix,
    get_adjacency_matrix_2direction,
    norm_adj_matrix,
    sym_norm_adj,
)
from .model import D3STN, topk_mix_matrix  # noqa: F401
from .predictor import Predictor  # noqa: F401
from .weights import load_flax_params  # noqa: F401
