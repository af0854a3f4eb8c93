from .api import (  # noqa: F401
    LEVY_AREA_APPROXIMATIONS,
    AntitheticBrownian,
    BaseBrownian,
    BrownianInterval,
    BrownianPath,
    BrownianTree,
    ReverseBrownian,
    brownian_interval_like,
)
from .prng import PRNGKey, key_from_jax  # noqa: F401
from .virtual_tree import (  # noqa: F401
    brownian_increment,
    brownian_value,
    davie_foster_area,
    h_to_u,
    space_time_levy_area,
)
