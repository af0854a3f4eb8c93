from .config import D3STNConfig, load_config  # noqa: F401
from .convert import REFERENCE_KEY_RULES, convert_reference_state_dict  # noqa: F401
from .dataset import (  # noqa: F401
    ScalerMinMax,
    ScalerStd,
    TrafficFlowDataset,
    synthetic_traffic_npz,
)
from .graph import (  # noqa: F401
    get_adjacency_matrix,
    get_adjacency_matrix_2direction,
    norm_adj_matrix,
    sym_norm_adj,
)
from .metrics import MAE, MAPE, MSE, RMSE, smis  # noqa: F401
from .model import D3STN, topk_mix_matrix  # noqa: F401
from .predictor import Predictor  # noqa: F401
from .trainer import Trainer, init_lag_anchors  # noqa: F401
from .weights import load_flax_params, to_flax_params  # noqa: F401
