from .local import LocalQueryRunner, QueryResult
from .executor import PlanExecutor, ExecutionError
