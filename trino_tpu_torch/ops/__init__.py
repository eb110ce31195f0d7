from . import kernels
from .compiler import compile_expression, ColumnLayout, CVal, CompileError
