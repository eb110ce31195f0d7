from .connector import TpchConnector, SCHEMA_SCALES

__all__ = ["TpchConnector", "SCHEMA_SCALES"]
