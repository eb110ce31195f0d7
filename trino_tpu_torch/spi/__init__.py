from . import types
from .page import Column, Dictionary, Page, page_from_numpy
from .types import Type
