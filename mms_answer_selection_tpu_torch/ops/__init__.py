from .batch_norm import bn_apply, bn_init  # noqa: F401
from .conv import conv2d, conv_init  # noqa: F401
from .dropout import dropout  # noqa: F401
from .embed import embed_init, embed_lookup, load_pretrained_vectors  # noqa: F401
from .losses import (  # noqa: F401
    contrastive_loss,
    euclidean_loss,
    hinge_loss,
    infogain_loss,
    multinomial_logistic_loss,
    pair_rank_loss,
    sigmoid_cross_entropy,
    softmax_cross_entropy,
)
from .pooling import (  # noqa: F401
    avg_pool2d,
    max_pool2d,
    pool2d_padded,
    spatial_pyramid_pool,
    stochastic_pool2d,
)
from .similarity import (  # noqa: F401
    fm_pool,
    sim_cross_bilinear,
    sim_cross_cosine,
    sim_cross_inv_euclidean,
    sim_matrix,
)
