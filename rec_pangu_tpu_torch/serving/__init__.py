from .export import export_program
from .scorer import construct_dummy_data, make_ranking_scorer, make_retrieval_scorer

__all__ = ["construct_dummy_data", "export_program", "make_ranking_scorer",
           "make_retrieval_scorer"]
