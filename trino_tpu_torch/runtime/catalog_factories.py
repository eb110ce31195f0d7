"""Connector factories for dynamic catalogs.

The port's counterpart of ``trino_tpu.runtime.catalog_factories`` (ref:
io.trino.connector.ConnectorServicesProvider and each plugin's
ConnectorFactory): CREATE CATALOG resolves the connector name against the
registered factories and builds it from the WITH properties, on the
runner's device. The ``tpch``, ``tpcds``, ``memory`` and ``blackhole``
factories are ported; ``lake`` raises naming its module. External code
registers more with ``register_connector_factory``; a factory takes
``(props, device)``.
"""

from __future__ import annotations

from typing import Callable, Dict

from .._unported import unported

_FACTORIES: Dict[str, Callable] = {}


def register_connector_factory(name: str, factory: Callable) -> None:
    _FACTORIES[name.lower()] = factory


_KNOWN_PROPS: Dict[str, frozenset] = {}


def create_connector(name: str, props: Dict[str, object], device=None):
    """The connector ``name`` built from ``props`` with its pages on
    ``device`` (default ``cuda``; see ``device.resolve_device``)."""
    factory = _FACTORIES.get(name.lower())
    if factory is None:
        raise ValueError(
            f"unknown connector {name!r}; available: {sorted(_FACTORIES)}"
        )
    known = _KNOWN_PROPS.get(name.lower())
    if known is not None:
        bad = sorted(set(props) - set(known))
        if bad:
            # a typo'd property must fail loudly, never mount a
            # default-configured catalog
            raise ValueError(
                f"unknown catalog properties for {name!r}: {bad}; "
                f"supported: {sorted(known)}"
            )
    return factory(props, device)


def _tpch(props, device):
    from ..connectors.tpch import TpchConnector

    return TpchConnector(
        scale=float(props.get("tpch.scale", props.get("scale", 0.01))),
        split_target_rows=int(
            props.get("tpch.split-target-rows", props.get("split_target_rows", 1 << 20))
        ),
        device=device,
    )


def _tpcds(props, device):
    from ..connectors.tpcds import TpcdsConnector

    return TpcdsConnector(
        scale=float(props.get("tpcds.scale", props.get("scale", 0.01))), device=device
    )


def _memory(props, device):
    from ..connectors.memory import MemoryConnector

    return MemoryConnector(device=device)


def _blackhole(props, device):
    from ..connectors.memory import BlackHoleConnector

    return BlackHoleConnector(device=device)


def _lake(props, device):
    unported("connectors.lake")


for _name, _f, _props in (
    ("tpch", _tpch, ("tpch.scale", "scale", "tpch.split-target-rows", "split_target_rows")),
    ("tpcds", _tpcds, ("tpcds.scale", "scale")),
    ("memory", _memory, ()),
    ("blackhole", _blackhole, ()),
    ("lake", _lake, ("lake.warehouse", "warehouse", "lake.local-root",
                     "local_root", "lake.max-rows-per-file", "max_rows_per_file")),
):
    register_connector_factory(_name, _f)
    _KNOWN_PROPS[_name] = frozenset(_props)
