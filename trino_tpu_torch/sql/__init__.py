from .parser import parse_statement, parse_expression, ParseError
from . import tree
