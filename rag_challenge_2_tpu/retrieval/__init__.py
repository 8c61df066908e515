from .engine import QueryEngine, SearchConfig, search_device
from .routing import extract_years_from_question, route_mask
from .sparse import BM25Retriever
from .traversal import TraversalResult, emit_hits, traverse
