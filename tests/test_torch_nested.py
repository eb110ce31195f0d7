"""ARRAY, MAP and ROW values, UNNEST, lambdas, the lane-valued aggregates
and the JSON and URL functions through ``trino_tpu.runtime.LocalQueryRunner``
and ``trino_tpu_torch``'s on the CPU: every statement of
``tests/test_nested_types.py``, ``tests/test_lambdas.py`` and
``tests/test_json_url.py``, and the map-valued aggregates, ``listagg`` and
aggregate ORDER BY of ``tests/test_agg_long_tail.py``, statement by statement
through both runners, one case per reference test, each over its reference
file's fixture (TPC-H at SF0.0005; the nested-type file adds a memory
catalog).

Column names, column types and rows must be identical (DOUBLE at 1e-9
relative, an array's or a map's DOUBLE elements too); where the reference
raises, the port must raise an exception of the same class with the same
message.
"""

import math

import pytest

from tests.test_torch_statements import _apply, _engine
from tests.test_torch_tpch_corpus import REL_TOL

SCALE = 0.0005

# reference file -> test -> statements, in the test's order
CASES = {
    "nested_types": {
        "constructor_and_subscript": [
            "SELECT ARRAY[1, 2, 3]", "SELECT ARRAY[1, 2, 3][2]", "SELECT ARRAY['x','y'][1]"],
        "cardinality": [
            "SELECT cardinality(ARRAY[1,2,3]), cardinality(ARRAY[])",
            "SELECT cardinality(CAST(NULL AS array(bigint)))"],
        "contains_and_position": [
            "SELECT contains(ARRAY[1,2,3], 2), contains(ARRAY[1,2,3], 9)",
            "SELECT array_position(ARRAY['a','b','c'], 'b')",
            "SELECT array_position(ARRAY[1,2], 9)"],
        "contains_null_semantics": [
            "SELECT contains(ARRAY[1, NULL], 9)", "SELECT contains(ARRAY[1, NULL], 1)"],
        "element_at_out_of_bounds_is_null": [
            "SELECT element_at(ARRAY[10,20], 5)", "SELECT element_at(ARRAY[10,20], 2)"],
        "min_max_sort_distinct": [
            "SELECT array_min(ARRAY[3,1,2]), array_max(ARRAY[3,1,2])",
            "SELECT array_sort(ARRAY[3,1,2])", "SELECT array_distinct(ARRAY[1,2,1,3,2])",
            "SELECT array_min(ARRAY[1, NULL])"],
        "concat_and_slice": [
            "SELECT ARRAY[1,2] || ARRAY[3]", "SELECT concat(ARRAY[1], ARRAY[2], ARRAY[3])",
            "SELECT slice(ARRAY[1,2,3,4], 2, 2)", "SELECT slice(ARRAY[1,2,3,4], -2, 2)"],
        "string_arrays_merge_dictionaries": [
            "SELECT ARRAY['b','a'] || ARRAY['c']", "SELECT array_sort(ARRAY['b','c','a'])"],
        "map_constructor_subscript": [
            "SELECT map(ARRAY['a','b'], ARRAY[1,2])['b']",
            "SELECT element_at(map(ARRAY['a'], ARRAY[1]), 'z')"],
        "map_keys_values_cardinality": [
            "SELECT map_keys(map(ARRAY['a','b'], ARRAY[1,2])), "
            "map_values(map(ARRAY['a','b'], ARRAY[1,2])), "
            "cardinality(map(ARRAY['a','b'], ARRAY[1,2]))"],
        "row_constructor_and_subscript": ["SELECT ROW(1, 'x')[1]", "SELECT ROW(1, 'x')[2]"],
        "map_decode": ["SELECT map(ARRAY['x','y'], ARRAY[1,2])"],
        "bare_unnest": ["SELECT t.x FROM UNNEST(ARRAY[1,2,3]) AS t(x)"],
        "with_ordinality": [
            "SELECT x, o FROM UNNEST(ARRAY[10,20]) WITH ORDINALITY AS t(x, o)"],
        "zip_pads_shorter_with_null": [
            "SELECT a, b FROM UNNEST(ARRAY[1,2,3], ARRAY['p','q']) AS u(a, b)"],
        "map_unnest": [
            "SELECT k, v FROM UNNEST(map(ARRAY['x','y'], ARRAY[1,2])) AS u(k, v) ORDER BY k"],
        "null_array_produces_no_rows": [
            "SELECT e FROM UNNEST(CAST(NULL AS array(bigint))) AS u(e)"],
        "correlated_cross_join_unnest": [
            "CREATE TABLE memory.default.nt AS "
            "SELECT 1 AS id, ARRAY[10,20] AS a UNION ALL SELECT 2, ARRAY[30]",
            "SELECT id, e FROM memory.default.nt CROSS JOIN UNNEST(a) AS u(e) ORDER BY id, e",
            "SELECT id, sum(e) FROM memory.default.nt CROSS JOIN UNNEST(a) AS u(e) "
            "GROUP BY id ORDER BY id"],
        "inner_join_unnest_applies_on_condition": [
            "SELECT count(*) FROM orders INNER JOIN UNNEST(ARRAY[1]) AS t(x) "
            "ON o_orderkey = 999999999",
            "SELECT count(*) FROM orders",
            "SELECT count(*) FROM orders INNER JOIN UNNEST(ARRAY[1,2]) AS t(x) ON x = 2"],
        "null_string_element": ["SELECT ARRAY['a', NULL]"],
        "dictionary_flows_through_accessors": [
            "SELECT ROW('x', 1)[1] = 'x', element_at(map(ARRAY[1,2], ARRAY['a','b']), 2), "
            "upper(ROW('x',1)[1]), map_values(map(ARRAY[1], ARRAY['z']))"],
        "array_distinct_keeps_first_occurrence_order": [
            "SELECT array_distinct(ARRAY[3, 1, 3, NULL, 1, NULL])"],
        "array_agg_grouped": [
            "SELECT l_returnflag, array_agg(l_linenumber) FROM lineitem "
            "WHERE l_orderkey < 10 GROUP BY l_returnflag ORDER BY l_returnflag"],
        "array_agg_global_and_roundtrip": [
            "SELECT cardinality(array_agg(l_orderkey)) FROM lineitem",
            "SELECT array_sort(array_agg(DISTINCT l_linestatus)) FROM lineitem"],
        "array_agg_then_unnest_roundtrip": [
            "SELECT e FROM (SELECT array_agg(l_linestatus) AS a FROM lineitem "
            "WHERE l_orderkey < 3) CROSS JOIN UNNEST(a) AS u(e)"],
    },
    "lambdas": {
        "transform_basic": ["SELECT transform(ARRAY[1,2,3], x -> x * 2)"],
        "transform_null_elements_flow_through": [
            "SELECT transform(ARRAY[1,NULL,3], x -> x + 1)"],
        "transform_outer_column_capture": [
            "SELECT transform(arr, x -> x + y) FROM (SELECT ARRAY[1,2] AS arr, 10 AS y) t"],
        "transform_string_result": [
            "SELECT transform(ARRAY[1,2], x -> CASE WHEN x > 1 THEN 'big' ELSE 'small' END)"],
        "transform_string_input": [
            "SELECT transform(ARRAY['a','bb'], x -> length(x))",
            "SELECT transform(ARRAY['a','b'], x -> upper(x))"],
        "transform_null_array": [
            "SELECT transform(CAST(NULL AS array(bigint)), x -> x + 1)"],
        "filter_basic": ["SELECT filter(ARRAY[5,-6,NULL,7], x -> x > 0)"],
        "filter_per_row": [
            "SELECT filter(arr, x -> x > y) FROM "
            "(SELECT ARRAY[1,5,9] AS arr, 4 AS y UNION ALL SELECT ARRAY[2,3], 1) t ORDER BY y"],
        "filter_empty_result": ["SELECT filter(ARRAY[1,2], x -> x > 99)"],
        "match_any_all_none": [
            "SELECT any_match(ARRAY[1,2], x -> x > 1), all_match(ARRAY[1,2], x -> x > 0), "
            "none_match(ARRAY[1,2], x -> x > 5)"],
        "match_three_valued_null": [
            "SELECT any_match(ARRAY[1,NULL], x -> x > 5)",
            "SELECT any_match(ARRAY[9,NULL], x -> x > 5)",
            "SELECT all_match(ARRAY[9,NULL], x -> x > 5)",
            "SELECT all_match(ARRAY[1,NULL], x -> x > 5)"],
        "zip_with_equal_lengths": [
            "SELECT zip_with(ARRAY[1,2], ARRAY[10,20], (a,b) -> a + b)"],
        "zip_with_shorter_extends_with_null": [
            "SELECT zip_with(ARRAY[1,2], ARRAY[10,20,30], (a,b) -> a + b)"],
        "reduce_sum": ["SELECT reduce(ARRAY[5,20,50], 0, (s,x) -> s + x, s -> s)"],
        "reduce_final_transform": [
            "SELECT reduce(ARRAY[5,20,50], CAST(0 AS double), (s,x) -> s + x, s -> s / 3.0)"],
        "reduce_per_row": [
            "SELECT reduce(arr, 0, (s,x) -> s + x * x, s -> s) FROM "
            "(SELECT ARRAY[1,2,3] AS arr UNION ALL SELECT ARRAY[4]) t"],
        "reduce_three_arg_defaults_to_identity_output": [
            "SELECT reduce(ARRAY[1,2,3], 100, (s,x) -> s + x)"],
        "map_transform_values": [
            "SELECT transform_values(MAP(ARRAY['k1','k2'], ARRAY[1,2]), (k,v) -> v * 10)"],
        "map_filter": [
            "SELECT map_filter(MAP(ARRAY['k1','k2'], ARRAY[1,2]), (k,v) -> v > 1)"],
        "string_case_constant_branches": [
            "SELECT CASE WHEN 1 > 0 THEN 'big' ELSE 'small' END"],
        "string_case_no_default_yields_null": [
            "SELECT CASE WHEN x > 1 THEN 'big' WHEN x > 0 THEN 'mid' END FROM "
            "(SELECT 1 AS x UNION ALL SELECT 2 UNION ALL SELECT 0) t ORDER BY x"],
        "string_case_mixing_column_and_constant": [
            "SELECT DISTINCT CASE WHEN l_quantity > 25 THEN 'hi' ELSE l_shipmode END "
            "FROM lineitem WHERE l_shipmode = 'AIR' ORDER BY 1"],
        "lambda_outside_higher_order": ["SELECT x -> x + 1"],
        "lambda_wrong_arity": ["SELECT transform(ARRAY[1], (x, y) -> x)"],
        "filter_requires_boolean": ["SELECT filter(ARRAY[1], x -> x + 1)"],
        "non_reserved_keyword_params": [
            "SELECT transform(ARRAY[1], day -> day + 1)",
            "SELECT zip_with(ARRAY[1], ARRAY[2], (x, day) -> x + day)"],
    },
    "json_url": {
        "json_extract_scalar": [
            """SELECT json_extract_scalar('{"a": {"b": 7}}', '$.a.b')""",
            """SELECT json_extract_scalar('{"a": "hi"}', '$["a"]')""",
            """SELECT json_extract_scalar('{"a": 1}', '$.missing')""",
            """SELECT json_extract_scalar('{"a": [1]}', '$.a')"""],
        "json_extract_json": [
            """SELECT json_extract('{"a": [1,2,{"c":3}]}', '$.a[2]')""",
            """SELECT json_array_get('[10, 20, 30]', 1)"""],
        "json_lengths_and_sizes": [
            "SELECT json_array_length('[1,2,3]')", """SELECT json_array_length('{"x":1}')""",
            """SELECT json_size('{"a": {"b":1,"c":2}}', '$.a')""",
            """SELECT json_size('{"a": 5}', '$.a')"""],
        "json_array_contains": [
            "SELECT json_array_contains('[1,2,3]', 2), json_array_contains('[1,2,3]', 9), "
            "json_array_contains('[\"x\"]', 'x'), json_array_contains('[1.5]', 1.5)",
            "SELECT json_array_contains('5', 5)"],
        "json_parse_and_format": [
            """SELECT json_parse('{"b": 1,  "a": 2}')""", "SELECT json_parse('not json')"],
        "json_over_table_column": [
            "SELECT DISTINCT json_extract_scalar('{\"m\": \"' || l_shipmode || '\"}', '$.m') "
            "FROM lineitem ORDER BY 1 LIMIT 3"],
        "url_extract_parts": [
            "SELECT url_extract_protocol('https://example.com:8080/p/a?q=1&r=two#frag'), "
            "url_extract_host('https://example.com:8080/p/a?q=1&r=two#frag'), "
            "url_extract_path('https://example.com:8080/p/a?q=1&r=two#frag'), "
            "url_extract_query('https://example.com:8080/p/a?q=1&r=two#frag'), "
            "url_extract_fragment('https://example.com:8080/p/a?q=1&r=two#frag')"],
        "url_extract_parameter": [
            "SELECT url_extract_parameter('https://e.com/?q=1&r=two', 'r'), "
            "url_extract_parameter('https://e.com/?q=1&r=two', 'zz')"],
        "url_encode_decode": ["SELECT url_encode('a b/c'), url_decode('a%20b%2Fc')"],
    },
    "agg_long_tail": {
        "map_agg_grouped": [
            "SELECT k, map_agg(k2, v) FROM (VALUES ('a','x',1),('a','y',2),"
            "('b','x',3)) t(k,k2,v) GROUP BY k ORDER BY k"],
        "map_agg_duplicate_keys_keep_one": [
            "SELECT map_agg(k, v) FROM (VALUES ('x',1),('x',9)) t(k,v)"],
        "map_agg_null_keys_skipped_and_empty_is_null": [
            "SELECT map_agg(k, v) FROM (VALUES ('x',1),(NULL,2)) t(k,v)",
            "SELECT map_agg(k, v) FROM (VALUES ('x',1)) t(k,v) WHERE k='zz'"],
        "map_agg_bigint_keys": [
            "SELECT map_agg(k, v) FROM (VALUES (10,'a'),(20,'b')) t(k,v)"],
        "histogram_basic": [
            "SELECT histogram(k) FROM (VALUES ('a'),('b'),('a'),(NULL)) t(k)"],
        "histogram_grouped_numeric": [
            "SELECT g, histogram(v) FROM (VALUES (1,5),(1,5),(1,6),(2,7)) "
            "t(g,v) GROUP BY g ORDER BY g"],
        "multimap_agg_basic": [
            "SELECT multimap_agg(k, v) FROM (VALUES ('x',1),('x',2),('y',3)) t(k,v)"],
        "multimap_agg_grouped": [
            "SELECT g, multimap_agg(k, v) FROM (VALUES (1,'x',1),(1,'x',2),"
            "(2,'y',3)) t(g,k,v) GROUP BY g ORDER BY g"],
        "listagg_within_group": [
            "SELECT k, listagg(v, ',') WITHIN GROUP (ORDER BY v) FROM "
            "(VALUES ('g1','b'),('g1','a'),('g2','z')) t(k,v) GROUP BY k ORDER BY k"],
        "listagg_default_separator_and_nulls_skipped": [
            "SELECT listagg(v) WITHIN GROUP (ORDER BY v) FROM (VALUES ('b'),('a'),(NULL)) t(v)"],
        "listagg_desc_order": [
            "SELECT listagg(v, '-') WITHIN GROUP (ORDER BY v DESC) FROM "
            "(VALUES ('a'),('c'),('b')) t(v)"],
        "array_agg_order_by_other_column": [
            "SELECT array_agg(v ORDER BY s DESC) FROM "
            "(VALUES ('p','a'),('q','b'),('r','c')) t(v,s)"],
        "array_agg_grouped_order_by": [
            "SELECT g, array_agg(v ORDER BY v) FROM "
            "(VALUES (1,3),(1,1),(2,5),(1,2)) t(g,v) GROUP BY g ORDER BY g"],
    },
}


def same_value(got, want) -> bool:
    """Equal values of the same Python type; a float at ``REL_TOL``
    relative, inside lists, dicts and tuples too."""
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want):
            return math.isnan(got)
        return got == want or abs(got - want) <= REL_TOL * max(abs(got), abs(want))
    if type(got) is not type(want):
        return False
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(same_value(g, w) for g, w in zip(got, want))
    if isinstance(want, dict):
        return list(got) == list(want) and all(same_value(got[k], want[k]) for k in want)
    return got == want


def assert_same(got, want, step) -> None:
    """The outcome of one statement: class and message where the reference
    raised, else names, types and every row."""
    assert got[0] == want[0], f"{step!r}: port {got} but reference {want}"
    if want[0] != "ok":
        assert got == want, f"{step!r}: port {got} but reference {want}"
        return
    assert got[1:3] == want[1:3], f"{step!r}: {got[1:3]} != {want[1:3]}"
    assert len(got[3]) == len(want[3]), f"{step!r}: {got[3]} != {want[3]}"
    for g, w in zip(got[3], want[3]):
        assert same_value(g, w), f"{step!r}: {g} != {w}"


@pytest.fixture(scope="module")
def runners():
    """(reference, port) TPC-H runners per reference file, made on first
    use; the nested-type file's fixture registers a memory catalog."""
    engines = (_engine(True), _engine(False))
    made = {}

    def get(kind):
        if kind not in made:
            pair = []
            for e in engines:
                r = e.Runner.tpch(scale=SCALE, **e.kw)
                if kind == "nested_types":
                    r.register_catalog("memory", e.memory.MemoryConnector(**e.kw))
                pair.append(r)
            made[kind] = tuple(pair)
        return made[kind]

    return engines, get


@pytest.mark.parametrize("case", [(f, t) for f in CASES for t in CASES[f]],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_nested_sql_matches_reference(case, runners):
    (ref_e, port_e), get = runners
    kind, test = case
    ref, port = get(kind)
    for sql in CASES[kind][test]:
        assert_same(_apply(port_e, port, sql), _apply(ref_e, ref, sql), sql)
