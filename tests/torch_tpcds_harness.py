"""The TPC-DS corpus through both engines at SF0.001 on the CPU, shared by
``test_torch_tpcds_corpus.py`` and ``test_torch_tpcds_corpus_2.py`` (two
files, so ``--dist loadfile`` spreads the reference's run of the corpus
over two workers)."""

from tests.test_torch_tpch_corpus import assert_same_rows
from tests.tpcds_corpus_texts import tpcds_corpus
from trino_tpu.connectors.tpcds import TpcdsConnector as RefConnector
from trino_tpu.metadata import Session as RefSession
from trino_tpu.runtime import LocalQueryRunner as RefRunner

from trino_tpu_torch.ops import hopper_kernels as HK
from trino_tpu_torch.ops import megakernels as MK
from trino_tpu_torch.runtime import LocalQueryRunner

SCALE = 0.001
SCHEMA = "sf0_001"
CORPUS = tpcds_corpus()
NAMES = list(CORPUS)
# q88's three keyless joins of its count subqueries take the serial path
CROSS_JOINS = {"q88": 2}


def reference_rows(names):
    ref = RefRunner(RefSession(catalog="tpcds", schema=SCHEMA))
    ref.register_catalog("tpcds", RefConnector(scale=SCALE))
    return {q: ref.execute(CORPUS[q]) for q in names}


def port_runner():
    return LocalQueryRunner.tpcds(scale=SCALE, device="cpu")


def check_query(query, fusion, reference, runner):
    """Rows identical to the reference's; with fusion on the only decline
    is ``cross_join`` (q88), with it off no fused phase runs; on the CPU no
    CUDA kernel launches."""
    runner.session.set("pallas_fusion", fusion)
    try:
        MK.reset_counts()
        got = runner.execute(CORPUS[query])
    finally:
        runner.session.set("pallas_fusion", True)
    assert_same_rows(got, reference[query])
    if fusion:
        declined = {k: v for k, v in MK.FALLBACKS.items() if v}
        assert declined == ({"cross_join": CROSS_JOINS[query]} if query in CROSS_JOINS else {})
        assert MK.LAUNCHES["probe"] > 0
    else:
        assert MK.LAUNCHES == {k: 0 for k in MK.LAUNCHES}
    assert HK.LAUNCHES == {k: 0 for k in HK.LAUNCHES}
