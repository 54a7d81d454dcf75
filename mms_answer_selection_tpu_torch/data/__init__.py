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
