"""The port's TPC-DS connector against the reference's: for every one of
the 24 tables at SF0.001, the split count and every split's page (each
column's data, NULL mask and dictionary, and the active mask) are
identical; the same for one split of each fact table at SF1. The
connector builds its pages on the device it is given."""

import numpy as np
import pytest
import torch

from trino_tpu.connectors import tpcds as ref_ds

from trino_tpu_torch.connectors import tpcds as ds
from trino_tpu_torch.spi.connector import SchemaTableName, TableHandle

TABLES = sorted(ds._TABLES)
FACT_TABLES = ("store_sales", "catalog_sales", "web_sales", "inventory")


def _handle(table, schema):
    return TableHandle("tpcds", SchemaTableName(schema, table))


def _ref_handle(table, schema):
    from trino_tpu.spi.connector import SchemaTableName as RS, TableHandle as RH

    return RH("tpcds", RS(schema, table))


def _assert_same_split(table, schema, split_id, ref_conn, port_conn):
    ncols = len(ds._TABLES[table])
    port_split = port_conn.split_manager().get_splits(_handle(table, schema))[split_id]
    ref_split = ref_conn.split_manager().get_splits(_ref_handle(table, schema))[split_id]
    got = port_conn.page_source_provider().create_page_source(port_split, range(ncols))
    want = ref_conn.page_source_provider().create_page_source(ref_split, range(ncols))
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    for (cname, _, _), gc, wc in zip(ds._TABLES[table], got.columns, want.columns):
        assert gc.type.display() == wc.type.display(), cname
        np.testing.assert_array_equal(gc.data.numpy(), np.asarray(wc.data), err_msg=cname)
        np.testing.assert_array_equal(gc.valid.numpy(), np.asarray(wc.valid), err_msg=cname)
        if wc.dictionary is None:
            assert gc.dictionary is None, cname
        else:
            assert list(gc.dictionary.values) == list(wc.dictionary.values), cname


def test_same_tables_and_schemas():
    assert TABLES == sorted(ref_ds._TABLES) and len(TABLES) == 24
    for t in TABLES:
        assert ds._TABLES[t] == ref_ds._TABLES[t]
    conn = ds.TpcdsConnector(scale=0.001, device="cpu")
    assert conn.metadata().list_schemas() == ["sf0_001", "sf0_01", "sf1"]


@pytest.mark.parametrize("table", TABLES)
def test_table_matches_reference_at_sf0_001(table):
    ref_conn = ref_ds.TpcdsConnector(scale=0.001)
    port_conn = ds.TpcdsConnector(scale=0.001, device="cpu")
    total = port_conn.split_count(table, 0.001)
    assert total == ref_conn.split_count(table, 0.001)
    for s in range(total):
        _assert_same_split(table, "sf0_001", s, ref_conn, port_conn)


@pytest.mark.parametrize("table", FACT_TABLES)
def test_fact_split_matches_reference_at_sf1(table):
    ref_conn = ref_ds.TpcdsConnector(scale=1.0)
    port_conn = ds.TpcdsConnector(scale=1.0, device="cpu")
    assert port_conn.split_count(table, 1.0) == ref_conn.split_count(table, 1.0)
    _assert_same_split(table, "sf1", 0, ref_conn, port_conn)


def test_nullable_foreign_keys_have_nulls():
    """TPC-DS fact foreign keys carry NULLs (the probe's invalid-key rows
    on the card), as the reference generator makes them."""
    conn = ds.TpcdsConnector(scale=0.001, device="cpu")
    split = conn.split_manager().get_splits(_handle("store_sales", "sf0_001"))[0]
    idx = [c[0] for c in ds._TABLES["store_sales"]].index("ss_customer_sk")
    page = conn.page_source_provider().create_page_source(split, [idx])
    nulls = int((page.active & ~page.columns[0].valid).sum())
    assert 0 < nulls < page.num_rows()


def test_entry_points_default_to_cuda(monkeypatch):
    from trino_tpu_torch.runtime import LocalQueryRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.TpcdsConnector(scale=0.001)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalQueryRunner.tpcds(scale=0.001)
    assert LocalQueryRunner.tpcds(scale=0.001, device="cpu").catalogs.get(
        "tpcds").device == torch.device("cpu")
