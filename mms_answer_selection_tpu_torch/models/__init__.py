from .mms_qa import (  # noqa: F401
    V3,
    V4,
    V4_2,
    V4_WIDE,
    V5,
    ConvBlock,
    MMSQAConfig,
    mms_qa_apply,
    mms_qa_init,
    param_spec,
)
from .pair_image import (  # noqa: F401
    PairImageConfig,
    pair_image_apply,
    pair_image_init,
)
from .graph_net import GraphNet, register_layer  # noqa: F401
from .pynet import Net  # noqa: F401
from .classifier import Classifier  # noqa: F401
from .detector import Detector  # noqa: F401
from .pysolver import (  # noqa: F401
    AdaDeltaSolver,
    AdaGradSolver,
    AdamSolver,
    NesterovSolver,
    RMSPropSolver,
    SGDSolver,
    Solver,
    get_solver,
)
from .caption_image import (  # noqa: F401
    CaptionImageConfig,
    caption_image_apply,
    caption_image_init,
    caption_image_score,
    encode_image,
)
