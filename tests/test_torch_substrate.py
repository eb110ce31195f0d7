"""The port's data substrate against the reference: storage dtypes, the
generated TPC-H columns, page_from_numpy, the package's import isolation and
its device rule. Inputs are made with numpy from a seed and go through both
packages; everything here is compared bit-exactly."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import trino_tpu.spi.types as rtypes
from trino_tpu.connectors.tpch import TpchConnector as RefTpch
from trino_tpu.spi.connector import SchemaTableName as RefName
from trino_tpu.spi.connector import TableHandle as RefHandle
from trino_tpu.spi.page import Dictionary as RefDictionary
from trino_tpu.spi.page import Page as RefPage

import trino_tpu_torch.spi.types as ptypes
from trino_tpu_torch.connectors.tpch import TpchConnector
from trino_tpu_torch.spi.connector import SchemaTableName as Name
from trino_tpu_torch.spi.connector import TableHandle as Handle
from trino_tpu_torch.spi.page import Column, Dictionary, page_from_numpy

TYPE_NAMES = [
    "boolean", "tinyint", "smallint", "integer", "bigint", "real", "double",
    "decimal(12,2)", "decimal(18,4)", "varchar", "varchar(25)", "char(1)",
    "date", "timestamp",
]


@pytest.mark.parametrize("name", TYPE_NAMES)
def test_storage_dtype_and_torch_dtype(name):
    ref, port = rtypes.parse_type(name), ptypes.parse_type(name)
    assert port.storage_dtype == ref.storage_dtype
    torch_dt = port.torch_dtype
    assert torch.empty(0, dtype=torch_dt).numpy().dtype == ref.storage_dtype


def _pages(table, scale=0.01):
    """(metadata, reference page, port page) for every split of ``table``."""
    ref, port = RefTpch(scale=scale), TpchConnector(scale=scale, device="cpu")
    rhandle = RefHandle("tpch", RefName("sf0_01", table))
    phandle = Handle("tpch", Name("sf0_01", table))
    meta = ref.metadata().get_table_metadata(rhandle.schema_table)
    cols = range(len(meta.columns))
    ref_splits = ref.split_manager().get_splits(rhandle)
    port_splits = port.split_manager().get_splits(phandle)
    assert [s.split_id for s in ref_splits] == [s.split_id for s in port_splits]
    for rs, ps in zip(ref_splits, port_splits):
        rp = ref.page_source_provider().create_page_source(rs, cols)
        pp = port.page_source_provider().create_page_source(ps, cols)
        yield meta, rp, pp


@pytest.mark.parametrize("table", ["lineitem", "orders"])
def test_generated_columns_match_reference(table):
    n_pages = 0
    for meta, rp, pp in _pages(table):
        n_pages += 1
        assert pp.capacity == rp.capacity
        np.testing.assert_array_equal(pp.active.numpy(), np.asarray(rp.active))
        for cm, rc, pc in zip(meta.columns, rp.columns, pp.columns):
            assert pc.type == ptypes.parse_type(cm.type.display()), cm.name
            assert pc.data.numpy().dtype == np.asarray(rc.data).dtype, cm.name
            np.testing.assert_array_equal(pc.data.numpy(), np.asarray(rc.data), cm.name)
            np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(rc.valid), cm.name)
            if rc.dictionary is None:
                assert pc.dictionary is None, cm.name
            else:
                assert list(pc.dictionary.values) == list(rc.dictionary.values), cm.name
    assert n_pages >= 1


def test_page_from_numpy_round_trip():
    rng = np.random.default_rng(7)
    n, cap = 37, 64
    names = ["bigint", "decimal(12,2)", "varchar", "date", "boolean", "double"]
    vocab = np.asarray(sorted({"AIR", "MAIL", "SHIP", "TRUCK"}), dtype=object)
    arrays = [
        rng.integers(-(10**12), 10**12, n),
        rng.integers(-(10**6), 10**6, n),
        rng.integers(0, len(vocab), n).astype(np.int32),
        rng.integers(8000, 10600, n).astype(np.int32),
        rng.random(n) < 0.5,
        rng.normal(size=n),
    ]
    valids = [rng.random(n) < 0.8 for _ in arrays]
    ref = RefPage.from_arrays(
        [rtypes.parse_type(t) for t in names], arrays, valids,
        [None, None, RefDictionary(vocab), None, None, None], capacity=cap,
    )
    active = np.asarray(ref.active) & (rng.random(cap) < 0.9)
    ref = ref.mask(active)
    # carry the reference page across: its contents as numpy
    port = page_from_numpy(
        [ptypes.parse_type(t) for t in names],
        [np.asarray(c.data) for c in ref.columns],
        [np.asarray(c.valid) for c in ref.columns],
        np.asarray(ref.active),
        [Dictionary(c.dictionary.values) if c.dictionary else None for c in ref.columns],
        device="cpu",
    )
    assert port.capacity == ref.capacity
    for rc, pc in zip(ref.columns, port.columns):
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(rc.data))
        np.testing.assert_array_equal(pc.valid.numpy(), np.asarray(rc.valid))
    assert port.to_pylist() == ref.to_pylist()


def test_import_loads_neither_jax_nor_reference():
    """Every module of the package, found by walking it (so a module added
    later is covered), imports without loading JAX or the reference."""
    code = (
        "import importlib, pkgutil, sys, trino_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(trino_tpu_torch.__path__,"
        " 'trino_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "need = {'trino_tpu_torch.connectors.tpcds', 'trino_tpu_torch.runtime.window',"
        " 'trino_tpu_torch.ops.int128', 'trino_tpu_torch.runtime.executor',"
        " 'trino_tpu_torch.connectors.memory', 'trino_tpu_torch.runtime.transactions',"
        " 'trino_tpu_torch.runtime.dml', 'trino_tpu_torch.runtime.catalog_factories',"
        " 'trino_tpu_torch.connectors.synthetic',"
        " 'trino_tpu_torch.connectors.information_schema',"
        " 'trino_tpu_torch.ops.scalar_functions', 'trino_tpu_torch.ops.string_functions'}\n"
        "missing = sorted(need - set(mods))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'trino_tpu' or m.startswith('trino_tpu.'))\n"
        "print(len(mods), missing, bad)\n"
        "sys.exit(1 if bad or missing or len(mods) < 50 else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_device_raises_without_cuda(monkeypatch):
    from trino_tpu_torch.runtime import LocalQueryRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalQueryRunner.tpch(scale=0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalQueryRunner.tpch(scale=0.01, device="cuda")
    bigint = ptypes.parse_type("bigint")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        page_from_numpy([bigint], [np.arange(4)], None, np.ones(4, dtype=bool))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Column.from_numpy(bigint, np.arange(4))
    # the CPU is used only when asked for
    runner = LocalQueryRunner.tpch(scale=0.01, device="cpu")
    assert runner.catalogs.get("tpch").device == torch.device("cpu")
    page = page_from_numpy([bigint], [np.arange(4)], None, np.ones(4, dtype=bool),
                           device="cpu")
    assert page.device == torch.device("cpu")
    assert Column.from_numpy(bigint, np.arange(4), device="cpu").data.device.type == "cpu"
