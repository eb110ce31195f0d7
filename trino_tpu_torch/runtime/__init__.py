from .local import ClientContext, LocalQueryRunner, QueryResult
from .executor import PlanExecutor, ExecutionError
