from .trec_qa import (  # noqa: F401
    build_vocab,
    compute_dfs,
    compute_overlap_features,
    encode_split,
    encode_tokens,
    load_dataset,
    parse_trec_xml,
    prepare_trec_qa,
    save_dataset,
    synthetic_corpus,
    synthetic_split,
    synthetic_world,
)
from .loader import ArrayDataset, BatchIterator  # noqa: F401
from .wikiqa import parse_wikiqa_tsv, prepare_wikiqa  # noqa: F401
from .pair_image import (  # noqa: F401
    PairImageDataset,
    parse_pair_list,
    synthetic_pair_corpus,
)
