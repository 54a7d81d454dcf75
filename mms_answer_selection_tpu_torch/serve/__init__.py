from .ivf import IVFIndex, ivf_recall  # noqa: F401
from .query_engine import QueryEngine, topk, topk_merge  # noqa: F401
from .server import QAServer  # noqa: F401
