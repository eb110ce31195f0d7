from .plan import LogicalPlan, format_plan
from .logical_planner import LogicalPlanner, SemanticError
from .optimizer import optimize
