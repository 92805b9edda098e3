"""Label/tag data model over the flat registry (counterpart of
``loghisto_tpu/labels``).

A labeled metric is one registry row under the canonical flat encoding
``name;k1=v1;k2=v2`` (sorted keys): ingest, the fused commit, the
wheel's rings and the lifecycle work on it unchanged.  This package is
the host layer on top: the canonical encoding (``model``), the selector
query language (``selector``), the generation-keyed inverted index that
compiles selectors to row ids (``index``) and the group_by results and
merge oracle (``groupby``, imported by the modules that need it).
"""

from loghisto_tpu_torch.labels.index import LabelIndex
from loghisto_tpu_torch.labels.model import (
    LabelError,
    LabelSet,
    base_of,
    canonical_name,
    is_labeled,
    labels_of,
    parse_canonical,
    split_processed,
)
from loghisto_tpu_torch.labels.selector import (
    Matcher,
    Selector,
    SelectorError,
    is_selector,
    parse_selector,
)

__all__ = [
    "LabelError",
    "LabelSet",
    "base_of",
    "canonical_name",
    "is_labeled",
    "labels_of",
    "parse_canonical",
    "split_processed",
    "Matcher",
    "Selector",
    "SelectorError",
    "is_selector",
    "parse_selector",
    "LabelIndex",
]
