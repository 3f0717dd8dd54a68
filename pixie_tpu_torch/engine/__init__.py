from pixie_tpu_torch.engine.executor import execute_plan
from pixie_tpu_torch.engine.result import QueryResult

__all__ = ["execute_plan", "QueryResult"]
