"""SQL abstract syntax tree.

Reference blueprint: core/trino-parser/src/main/java/io/trino/sql/tree/ (hundreds of
node classes; SURVEY.md §2.2). We keep the same node taxonomy — Statement / Query /
QueryBody / Relation / Expression — as frozen dataclasses. The planner consumes this
AST via the analyzer; a *separate* IR expression language (trino_tpu.sql.ir, mirroring
io.trino.sql.ir) is what the optimizer and compiler see.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Sequence, Tuple


class Node:
    """Base AST node."""

    __slots__ = ()


# --------------------------------------------------------------------------- #
# Expressions (ref: sql/tree/Expression.java and subclasses)
# --------------------------------------------------------------------------- #


class Expression(Node):
    __slots__ = ()


@dataclass(frozen=True)
class Identifier(Expression):
    name: str  # already lower-cased unless delimited

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class QualifiedName(Node):
    parts: Tuple[str, ...]

    def __str__(self):
        return ".".join(self.parts)

    @property
    def last(self) -> str:
        return self.parts[-1]


@dataclass(frozen=True)
class Dereference(Expression):
    """Qualified column reference, e.g. l.orderkey (ref: DereferenceExpression.java)."""

    base: Expression
    fieldname: str

    def __str__(self):
        return f"{self.base}.{self.fieldname}"


@dataclass(frozen=True)
class Array(Expression):
    """ARRAY[e1, ...] constructor (ref: sql/tree/ArrayConstructor.java)."""

    items: tuple = ()


@dataclass(frozen=True)
class Subscript(Expression):
    """base[index] — array element / map value access (ref: SubscriptExpression.java)."""

    base: Expression = None
    index: Expression = None


@dataclass(frozen=True)
class LongLiteral(Expression):
    value: int


@dataclass(frozen=True)
class DoubleLiteral(Expression):
    value: float


@dataclass(frozen=True)
class DecimalLiteral(Expression):
    text: str  # e.g. "0.05" — scale preserved


@dataclass(frozen=True)
class StringLiteral(Expression):
    value: str


@dataclass(frozen=True)
class BooleanLiteral(Expression):
    value: bool


@dataclass(frozen=True)
class NullLiteral(Expression):
    pass


@dataclass(frozen=True)
class DateLiteral(Expression):
    """DATE 'YYYY-MM-DD' (ref: GenericLiteral with type DATE)."""

    text: str


@dataclass(frozen=True)
class TimestampLiteral(Expression):
    text: str


@dataclass(frozen=True)
class TimeLiteral(Expression):
    """TIME 'HH:MM:SS.fff' (ref: GenericLiteral with type TIME)."""

    text: str


@dataclass(frozen=True)
class IntervalLiteral(Expression):
    """INTERVAL '3' MONTH (ref: sql/tree/IntervalLiteral.java)."""

    value: str
    unit: str  # year|month|day|hour|minute|second
    sign: int = 1


class ArithmeticOp(Enum):
    ADD = "+"
    SUBTRACT = "-"
    MULTIPLY = "*"
    DIVIDE = "/"
    MODULUS = "%"


@dataclass(frozen=True)
class ArithmeticBinary(Expression):
    op: ArithmeticOp
    left: Expression
    right: Expression


@dataclass(frozen=True)
class ArithmeticUnary(Expression):
    op: str  # '-' or '+'
    value: Expression


class ComparisonOp(Enum):
    EQUAL = "="
    NOT_EQUAL = "<>"
    LESS_THAN = "<"
    LESS_THAN_OR_EQUAL = "<="
    GREATER_THAN = ">"
    GREATER_THAN_OR_EQUAL = ">="
    IS_DISTINCT_FROM = "IS DISTINCT FROM"


@dataclass(frozen=True)
class Comparison(Expression):
    op: ComparisonOp
    left: Expression
    right: Expression


@dataclass(frozen=True)
class Logical(Expression):
    op: str  # 'AND' | 'OR'
    terms: Tuple[Expression, ...]


@dataclass(frozen=True)
class Not(Expression):
    value: Expression


@dataclass(frozen=True)
class IsNull(Expression):
    value: Expression


@dataclass(frozen=True)
class IsNotNull(Expression):
    value: Expression


@dataclass(frozen=True)
class Between(Expression):
    value: Expression
    min: Expression
    max: Expression
    negated: bool = False


@dataclass(frozen=True)
class InList(Expression):
    value: Expression
    items: Tuple[Expression, ...]
    negated: bool = False


@dataclass(frozen=True)
class InSubquery(Expression):
    value: Expression
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class Exists(Expression):
    query: "Query"
    negated: bool = False


@dataclass(frozen=True)
class ScalarSubquery(Expression):
    query: "Query"


@dataclass(frozen=True)
class Like(Expression):
    value: Expression
    pattern: Expression
    escape: Optional[Expression] = None
    negated: bool = False


@dataclass(frozen=True)
class FunctionCall(Expression):
    name: QualifiedName
    args: Tuple[Expression, ...]
    distinct: bool = False
    is_star: bool = False  # count(*)
    filter: Optional[Expression] = None
    window: Optional["WindowSpec"] = None
    # aggregate ordering: array_agg(x ORDER BY y) / listagg(..) WITHIN GROUP
    # (ORDER BY y) (ref: sql/tree/FunctionCall.java orderBy field)
    order_by: Tuple["SortItem", ...] = ()
    # IGNORE NULLS | RESPECT NULLS (ref: FunctionCall.nullTreatment), for
    # lead/lag/first_value/last_value/nth_value
    null_treatment: Optional[str] = None


@dataclass(frozen=True)
class WindowFrame(Node):
    """ROWS/RANGE frame (ref: sql/tree/WindowFrame.java). Bound kinds:
    UNBOUNDED_PRECEDING | PRECEDING | CURRENT_ROW | FOLLOWING |
    UNBOUNDED_FOLLOWING; value set for PRECEDING/FOLLOWING."""

    type_: str  # "ROWS" | "RANGE"
    start_kind: str
    end_kind: str
    start_value: Optional[int] = None
    end_value: Optional[int] = None


@dataclass(frozen=True)
class WindowSpec(Node):
    """OVER (PARTITION BY ... ORDER BY ... [frame]) (ref: sql/tree/WindowSpecification.java)."""

    partition_by: Tuple[Expression, ...]
    order_by: Tuple["SortItem", ...]
    frame: Optional[WindowFrame] = None


@dataclass(frozen=True)
class Lambda(Expression):
    """x -> expr | (x, y) -> expr (ref: sql/tree/LambdaExpression.java);
    only valid as an argument of a higher-order function."""

    params: Tuple[str, ...] = ()
    body: Expression = None


@dataclass(frozen=True)
class WhenClause(Node):
    condition: Expression
    result: Expression


@dataclass(frozen=True)
class SearchedCase(Expression):
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression]


@dataclass(frozen=True)
class SimpleCase(Expression):
    operand: Expression
    when_clauses: Tuple[WhenClause, ...]
    default: Optional[Expression]


@dataclass(frozen=True)
class Cast(Expression):
    value: Expression
    type_name: str
    safe: bool = False  # TRY_CAST


@dataclass(frozen=True)
class Extract(Expression):
    field_name: str  # YEAR|MONTH|DAY|...
    value: Expression


@dataclass(frozen=True)
class CurrentDate(Expression):
    pass


@dataclass(frozen=True)
class Row(Expression):
    items: Tuple[Expression, ...]


@dataclass(frozen=True)
class Star(Expression):
    """Bare ``*`` or ``t.*`` in a select list."""

    qualifier: Optional[QualifiedName] = None


# --------------------------------------------------------------------------- #
# Relations (ref: sql/tree/Relation.java subclasses)
# --------------------------------------------------------------------------- #


class Relation(Node):
    __slots__ = ()


@dataclass(frozen=True)
class Table(Relation):
    name: QualifiedName
    # time travel (FOR VERSION AS OF n — iceberg-style snapshot reads)
    version: object = None


@dataclass(frozen=True)
class AliasedRelation(Relation):
    relation: Relation
    alias: str
    column_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class TableSubquery(Relation):
    query: "Query"


@dataclass(frozen=True)
class Unnest(Relation):
    expressions: Tuple[Expression, ...]
    with_ordinality: bool = False


@dataclass(frozen=True)
class TableFunctionRelation(Relation):
    """TABLE(fn(args)) in FROM (ref: sql/tree/TableFunctionInvocation.java).

    ``args`` holds positional Expressions; ``named_args`` holds
    (name, value) pairs where value is an Expression, a Relation (TABLE
    argument), or a Descriptor (DESCRIPTOR(col, ...)) — the polymorphic
    table-function argument model (spi/function/table/Argument.java)."""

    name: str = ""
    args: Tuple[Expression, ...] = ()
    named_args: Tuple[Tuple[str, object], ...] = ()


@dataclass(frozen=True)
class Descriptor(Node):
    """DESCRIPTOR(a, b, ...) argument (sql/tree/Descriptor.java)."""

    columns: Tuple[str, ...] = ()


# --------------------------------------------------------------------------- #
# MATCH_RECOGNIZE (ref: sql/tree/PatternRecognitionRelation.java + the
# rowPattern grammar rules in SqlBase.g4)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class PatternVariable(Node):
    name: str


@dataclass(frozen=True)
class PatternConcatenation(Node):
    elements: Tuple[Node, ...]


@dataclass(frozen=True)
class PatternAlternation(Node):
    alternatives: Tuple[Node, ...]


@dataclass(frozen=True)
class PatternQuantified(Node):
    """element{min,max}; max None = unbounded; greedy False = reluctant (?)."""

    element: Node
    min: int
    max: Optional[int]
    greedy: bool = True


@dataclass(frozen=True)
class MeasureItem(Node):
    expression: Expression
    name: str
    semantics: Optional[str] = None  # RUNNING | FINAL | None (context default)


@dataclass(frozen=True)
class SkipTo(Node):
    """AFTER MATCH SKIP: PAST_LAST | TO_NEXT_ROW | TO_FIRST var | TO_LAST var."""

    mode: str = "PAST_LAST"
    target: Optional[str] = None


@dataclass(frozen=True)
class MatchRecognize(Relation):
    relation: Relation = None
    partition_by: Tuple[Expression, ...] = ()
    order_by: Tuple["SortItem", ...] = ()
    measures: Tuple[MeasureItem, ...] = ()
    rows_per_match: str = "ONE"  # ONE | ALL
    after_skip: SkipTo = SkipTo()
    pattern: Node = None
    subsets: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    defines: Tuple[Tuple[str, Expression], ...] = ()


class JoinType(Enum):
    INNER = "INNER"
    LEFT = "LEFT"
    RIGHT = "RIGHT"
    FULL = "FULL"
    CROSS = "CROSS"
    IMPLICIT = "IMPLICIT"


@dataclass(frozen=True)
class JoinOn(Node):
    expression: Expression


@dataclass(frozen=True)
class JoinUsing(Node):
    columns: Tuple[str, ...]


@dataclass(frozen=True)
class NaturalJoin(Node):
    pass


@dataclass(frozen=True)
class Join(Relation):
    join_type: JoinType
    left: Relation
    right: Relation
    criteria: Optional[Node] = None  # JoinOn | JoinUsing | NaturalJoin | None (cross)


@dataclass(frozen=True)
class Lateral(Relation):
    query: "Query"


# --------------------------------------------------------------------------- #
# Query structure (ref: sql/tree/{Query,QuerySpecification,Select,...}.java)
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class SortItem(Node):
    key: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = type default (last for ASC)


@dataclass(frozen=True)
class SelectItem(Node):
    expression: Expression
    alias: Optional[str] = None


@dataclass(frozen=True)
class GroupingElement(Node):
    expressions: Tuple[Expression, ...]
    kind: str = "simple"  # simple | rollup | cube | grouping_sets
    # for GROUPING SETS: the alternative sets (expressions is their union)
    sets: Optional[Tuple[Tuple[Expression, ...], ...]] = None


class QueryBody(Node):
    __slots__ = ()


@dataclass(frozen=True)
class QuerySpecification(QueryBody):
    select_items: Tuple[SelectItem, ...]
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expression] = None
    group_by: Tuple[GroupingElement, ...] = ()
    having: Optional[Expression] = None
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


class SetOpType(Enum):
    UNION = "UNION"
    INTERSECT = "INTERSECT"
    EXCEPT = "EXCEPT"


@dataclass(frozen=True)
class SetOperation(QueryBody):
    op: SetOpType
    left: QueryBody
    right: QueryBody
    distinct: bool = True  # False == ALL


@dataclass(frozen=True)
class Values(QueryBody):
    rows: Tuple[Expression, ...]  # each a Row or single expression


@dataclass(frozen=True)
class TableRef(QueryBody):
    """``TABLE t`` shorthand."""

    name: QualifiedName


@dataclass(frozen=True)
class WithQuery(Node):
    name: str
    query: "Query"
    column_names: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Query(Node):
    body: QueryBody
    with_queries: Tuple[WithQuery, ...] = ()
    order_by: Tuple[SortItem, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


# --------------------------------------------------------------------------- #
# Statements (ref: sql/tree/Statement.java subclasses)
# --------------------------------------------------------------------------- #


class Statement(Node):
    __slots__ = ()


@dataclass(frozen=True)
class QueryStatement(Statement):
    query: Query


@dataclass(frozen=True)
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    explain_type: str = "LOGICAL"  # LOGICAL | DISTRIBUTED | IO
    # EXPLAIN ANALYZE VERBOSE: per-operator device/host/compile columns
    verbose: bool = False


@dataclass(frozen=True)
class ShowTables(Statement):
    schema: Optional[QualifiedName] = None


@dataclass(frozen=True)
class ShowSchemas(Statement):
    catalog: Optional[str] = None


@dataclass(frozen=True)
class ShowColumns(Statement):
    table: QualifiedName = None


@dataclass(frozen=True)
class ShowCatalogs(Statement):
    pass


@dataclass(frozen=True)
class ShowSession(Statement):
    pass


@dataclass(frozen=True)
class SetSession(Statement):
    name: QualifiedName = None
    value: Expression = None


@dataclass(frozen=True)
class ResetSession(Statement):
    """ref: sql/tree/ResetSession.java + execution/ResetSessionTask."""

    name: QualifiedName = None


@dataclass(frozen=True)
class CreateTableAsSelect(Statement):
    name: QualifiedName = None
    query: Query = None
    if_not_exists: bool = False


@dataclass(frozen=True)
class CreateCatalog(Statement):
    """CREATE CATALOG name USING connector [WITH (k = v, ...)]
    (ref: sql/tree/CreateCatalog.java)."""

    name: str = ""
    connector: str = ""
    properties: Tuple[Tuple[str, object], ...] = ()
    if_not_exists: bool = False


@dataclass(frozen=True)
class DropCatalog(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass(frozen=True)
class CreateTable(Statement):
    """CREATE TABLE name (col type, ...) (ref: sql/tree/CreateTable.java)."""

    name: QualifiedName = None
    columns: Tuple[Tuple[str, str], ...] = ()  # (name, type text)
    if_not_exists: bool = False


@dataclass(frozen=True)
class InsertInto(Statement):
    table: QualifiedName = None
    columns: Tuple[str, ...] = ()
    query: Query = None


@dataclass(frozen=True)
class DropTable(Statement):
    name: QualifiedName = None
    if_exists: bool = False


@dataclass(frozen=True)
class CreateView(Statement):
    """CREATE [OR REPLACE] VIEW name AS query (ref: sql/tree/CreateView.java).
    ``query_text`` keeps the original SQL of the body: views are stored as
    text and re-analyzed at use, like the reference (ViewDefinition)."""

    name: QualifiedName = None
    query: Query = None
    query_text: str = ""
    replace: bool = False


@dataclass(frozen=True)
class DropView(Statement):
    """DROP VIEW [IF EXISTS] name (ref: sql/tree/DropView.java)."""

    name: QualifiedName = None
    if_exists: bool = False


@dataclass(frozen=True)
class CreateFunction(Statement):
    """CREATE [OR REPLACE] FUNCTION name(p type, ...) RETURNS type RETURN expr
    (ref: sql/tree/CreateFunction.java + routine/FunctionSpecification — the
    expression-bodied subset of SQL routines; compiled by inlining at use)."""

    name: QualifiedName = None
    parameters: Tuple[Tuple[str, str], ...] = ()  # (name, type text)
    return_type: str = ""
    body: Expression = None
    body_text: str = ""
    replace: bool = False


@dataclass(frozen=True)
class DropFunction(Statement):
    """DROP FUNCTION [IF EXISTS] name (ref: sql/tree/DropFunction.java)."""

    name: QualifiedName = None
    if_exists: bool = False


@dataclass(frozen=True)
class Use(Statement):
    """USE [catalog.]schema (ref: sql/tree/Use.java)."""

    catalog: Optional[str] = None
    schema: str = ""


@dataclass(frozen=True)
class ShowFunctions(Statement):
    """SHOW FUNCTIONS (ref: sql/tree/ShowFunctions.java)."""


@dataclass(frozen=True)
class Grant(Statement):
    """GRANT privs ON [TABLE] t TO [USER] grantee (ref: sql/tree/Grant.java)."""

    privileges: Tuple[str, ...] = ()  # empty = ALL PRIVILEGES
    table: QualifiedName = None
    grantee: str = ""


@dataclass(frozen=True)
class Revoke(Statement):
    """REVOKE privs ON [TABLE] t FROM [USER] grantee (sql/tree/Revoke.java)."""

    privileges: Tuple[str, ...] = ()
    table: QualifiedName = None
    grantee: str = ""


@dataclass(frozen=True)
class ShowCreate(Statement):
    """SHOW CREATE TABLE|VIEW name (ref: sql/tree/ShowCreate.java)."""

    kind: str = "table"  # "table" | "view"
    name: QualifiedName = None


@dataclass(frozen=True)
class Call(Statement):
    """CALL catalog.schema.procedure(arg, ...) (ref: sql/tree/Call.java +
    execution/CallTask — procedures live in connectors; the builtin registry
    is the system catalog's, e.g. system.runtime.kill_query)."""

    name: QualifiedName = None
    arguments: Tuple[Expression, ...] = ()


@dataclass(frozen=True)
class Parameter(Expression):
    """Positional ``?`` parameter (ref: sql/tree/Parameter.java); bound by
    EXECUTE ... USING."""

    index: int = 0


@dataclass(frozen=True)
class Prepare(Statement):
    """PREPARE name FROM statement (ref: sql/tree/Prepare.java)."""

    name: str = ""
    statement: Statement = None
    # original source text of the body, for the X-Trino-Added-Prepare
    # response header (the client re-sends it on later requests)
    body_text: str = ""


@dataclass(frozen=True)
class ExecuteStmt(Statement):
    """EXECUTE name [USING expr, ...] (ref: sql/tree/Execute.java)."""

    name: str = ""
    parameters: Tuple[Expression, ...] = ()


@dataclass(frozen=True)
class Deallocate(Statement):
    """DEALLOCATE PREPARE name (ref: sql/tree/Deallocate.java)."""

    name: str = ""


@dataclass(frozen=True)
class DescribeInput(Statement):
    name: str = ""


@dataclass(frozen=True)
class DescribeOutput(Statement):
    name: str = ""


@dataclass(frozen=True)
class StartTransaction(Statement):
    """ref: sql/tree/StartTransaction.java (transaction/TransactionManager)."""

    read_only: bool = False
    isolation: str = "SERIALIZABLE"


@dataclass(frozen=True)
class Commit(Statement):
    pass


@dataclass(frozen=True)
class Rollback(Statement):
    pass


@dataclass(frozen=True)
class Delete(Statement):
    """DELETE FROM t [WHERE cond] (ref: sql/tree/Delete.java)."""

    table: QualifiedName = None
    where: Optional[Expression] = None


@dataclass(frozen=True)
class Update(Statement):
    """UPDATE t SET c = e, ... [WHERE cond] (ref: sql/tree/Update.java)."""

    table: QualifiedName = None
    assignments: Tuple[Tuple[str, Expression], ...] = ()
    where: Optional[Expression] = None


@dataclass(frozen=True)
class MergeCase(Node):
    """One WHEN [NOT] MATCHED [AND cond] THEN ... clause."""

    matched: bool = True
    condition: Optional[Expression] = None
    operation: str = "update"  # update | delete | insert
    # update: ((col, expr), ...); insert: columns + values
    assignments: Tuple[Tuple[str, Expression], ...] = ()
    insert_columns: Tuple[str, ...] = ()
    insert_values: Tuple[Expression, ...] = ()


@dataclass(frozen=True)
class Merge(Statement):
    """MERGE INTO target USING source ON cond WHEN ... (ref: sql/tree/Merge.java)."""

    target: QualifiedName = None
    target_alias: Optional[str] = None
    source: Relation = None
    on: Expression = None
    cases: Tuple[MergeCase, ...] = ()


# --------------------------------------------------------------------------- #
# prepared-statement parameter utilities (ref: execution/ParameterExtractor +
# sql/planner ParameterRewriter — generic frozen-dataclass tree rewrite)
# --------------------------------------------------------------------------- #


def count_parameters(node) -> int:
    """Number of distinct positional parameters in a statement tree."""
    import dataclasses

    seen = set()

    def walk(v):
        if isinstance(v, Parameter):
            seen.add(v.index)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)

    walk(node)
    return len(seen)


def substitute_parameters(node, values):
    """Replace every Parameter(i) with ``values[i]`` (an Expression),
    rebuilding only the spine that changed."""
    import dataclasses

    def sub(v):
        if isinstance(v, Parameter):
            if v.index >= len(values):
                raise ValueError(
                    f"parameter ?{v.index + 1} has no bound value "
                    f"({len(values)} provided)"
                )
            return values[v.index]
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes = {}
            for f in dataclasses.fields(v):
                old = getattr(v, f.name)
                new = sub(old)
                if new is not old:
                    changes[f.name] = new
            return dataclasses.replace(v, **changes) if changes else v
        if isinstance(v, tuple):
            new = tuple(sub(x) for x in v)
            return new if any(a is not b for a, b in zip(new, v)) else v
        return v

    return sub(node)
