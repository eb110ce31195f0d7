"""Recursive-descent SQL parser producing the AST in :mod:`trino_tpu.sql.tree`.

Reference blueprint: core/trino-parser/src/main/java/io/trino/sql/parser/
SqlParser.java:104 (`createStatement`) + AstBuilder.java (the ANTLR visitor, 4,770
LoC) over core/trino-grammar/.../SqlBase.g4. The grammar subset implemented here is
the SELECT core plus the statements the engine executes in round 1; the structure
mirrors the g4 rules (queryNoWith / queryTerm / querySpecification / booleanExpression
/ valueExpression / primaryExpression) so coverage can be widened rule by rule.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .lexer import Token, TokenType, tokenize, NON_RESERVED
from . import tree as t


class ParseError(ValueError):
    pass


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = tokenize(sql)
        self.pos = 0
        self._param_count = 0  # positional ? parameters seen so far

    # ------------------------------------------------------------------ utils

    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.pos + offset, len(self.tokens) - 1)]

    def at_keyword(self, *words: str) -> bool:
        tok = self.peek()
        return tok.type == TokenType.KEYWORD and tok.value in words

    def at_op(self, *ops: str) -> bool:
        tok = self.peek()
        return tok.type == TokenType.OP and tok.value in ops

    def advance(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.type != TokenType.EOF:
            self.pos += 1
        return tok

    def accept_keyword(self, *words: str) -> bool:
        if self.at_keyword(*words):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_keyword(self, word: str) -> Token:
        if not self.at_keyword(word):
            raise ParseError(f"expected {word} but found {self.peek().value!r} at {self.peek().pos}")
        return self.advance()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise ParseError(f"expected {op!r} but found {self.peek().value!r} at {self.peek().pos}")
        return self.advance()

    def identifier(self) -> str:
        tok = self.peek()
        if tok.type == TokenType.IDENT:
            self.advance()
            return tok.value
        if tok.type == TokenType.QUOTED_IDENT:
            self.advance()
            return tok.value
        if tok.type == TokenType.KEYWORD and tok.value in NON_RESERVED:
            self.advance()
            return tok.value.lower()
        raise ParseError(f"expected identifier but found {tok.value!r} at {tok.pos}")

    def qualified_name(self) -> t.QualifiedName:
        parts = [self.identifier()]
        while self.at_op(".") and self.peek(1).type in (
            TokenType.IDENT,
            TokenType.QUOTED_IDENT,
            TokenType.KEYWORD,
        ):
            self.advance()
            parts.append(self.identifier())
        return t.QualifiedName(tuple(parts))

    # -------------------------------------------------------------- statements

    def parse_statement(self) -> t.Statement:
        stmt = self._statement()
        self.accept_op(";")
        if self.peek().type != TokenType.EOF:
            raise ParseError(f"unexpected trailing input at {self.peek().pos}: {self.peek().value!r}")
        return stmt

    def _statement(self) -> t.Statement:
        if self.accept_keyword("EXPLAIN"):
            explain_type = "LOGICAL"
            if self.accept_op("("):
                self.expect_keyword("TYPE")
                explain_type = self.advance().value.upper()
                self.expect_op(")")
            analyze = self.accept_keyword("ANALYZE")
            # VERBOSE lexes as a plain identifier (not in KEYWORDS)
            verbose = False
            if analyze and (
                self.peek().type == TokenType.IDENT
                and self.peek().value == "verbose"
            ):
                self.advance()
                verbose = True
            inner = self._statement()
            return t.Explain(
                statement=inner, analyze=analyze, explain_type=explain_type,
                verbose=verbose,
            )
        # CATALOG lexes as a plain identifier (not in KEYWORDS)
        if self.at_keyword("DROP") and (
            self.peek(1).type == TokenType.IDENT and self.peek(1).value == "catalog"
        ):
            self.advance()  # DROP
            self.advance()  # CATALOG
            if_exists = False
            if self.accept_keyword("IF"):
                self.expect_keyword("EXISTS")
                if_exists = True
            return t.DropCatalog(name=self.identifier(), if_exists=if_exists)
        if self.accept_keyword("USE"):
            qn = self.qualified_name()
            if len(qn.parts) == 1:
                return t.Use(schema=qn.parts[0])
            if len(qn.parts) == 2:
                return t.Use(catalog=qn.parts[0], schema=qn.parts[1])
            raise ParseError("USE expects [catalog.]schema")
        if self.at_keyword("SHOW"):
            return self._show()
        if self.accept_keyword("SET"):
            self.expect_keyword("SESSION")
            name = self.qualified_name()
            self.expect_op("=")
            value = self.expression()
            return t.SetSession(name=name, value=value)
        if self.accept_keyword("RESET"):
            self.expect_keyword("SESSION")
            return t.ResetSession(name=self.qualified_name())
        if self.accept_keyword("CREATE"):
            if (
                self.peek().type == TokenType.IDENT
                and self.peek().value == "catalog"
            ):
                self.advance()
                if_not_exists = False
                if self.accept_keyword("IF"):
                    self.expect_keyword("NOT")
                    self.expect_keyword("EXISTS")
                    if_not_exists = True
                name = self.identifier()
                self.expect_keyword("USING")
                connector = self.identifier()
                props = []
                if self.accept_keyword("WITH"):
                    self.expect_op("(")
                    while True:
                        k = self.identifier() if self.peek().type != TokenType.STRING else self.advance().value
                        self.expect_op("=")
                        neg = self.accept_op("-")
                        tok = self.peek()
                        if tok.type == TokenType.INTEGER:
                            self.advance()
                            v: object = -int(tok.value) if neg else int(tok.value)
                        elif tok.type in (TokenType.DECIMAL, TokenType.FLOAT):
                            self.advance()
                            v = -float(tok.value) if neg else float(tok.value)
                        elif not neg and tok.type == TokenType.STRING:
                            self.advance()
                            v = tok.value
                        elif not neg and tok.type == TokenType.KEYWORD and tok.value in ("TRUE", "FALSE"):
                            self.advance()
                            v = tok.value == "TRUE"
                        else:
                            raise ParseError(
                                f"catalog property value must be a literal, "
                                f"found {tok.value!r} at {tok.pos}"
                            )
                        props.append((str(k), v))
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                return t.CreateCatalog(
                    name=name, connector=connector,
                    properties=tuple(props), if_not_exists=if_not_exists,
                )
            if self.accept_keyword("OR"):
                self.expect_keyword("REPLACE")
                if self.accept_keyword("FUNCTION"):
                    return self._create_function(replace=True)
                self.expect_keyword("VIEW")
                name = self.qualified_name()
                self.expect_keyword("AS")
                body_start = self.peek().pos
                query = self.parse_query()
                return t.CreateView(
                    name=name, query=query, replace=True,
                    query_text=self.sql[body_start:].strip().rstrip(";").strip(),
                )
            if self.accept_keyword("FUNCTION"):
                return self._create_function(replace=False)
            if self.accept_keyword("VIEW"):
                name = self.qualified_name()
                self.expect_keyword("AS")
                body_start = self.peek().pos
                query = self.parse_query()
                return t.CreateView(
                    name=name, query=query,
                    query_text=self.sql[body_start:].strip().rstrip(";").strip(),
                )
            self.expect_keyword("TABLE")
            if_not_exists = False
            if self.accept_keyword("IF"):
                self.expect_keyword("NOT")
                self.expect_keyword("EXISTS")
                if_not_exists = True
            name = self.qualified_name()
            if self.accept_op("("):
                # CREATE TABLE t (col type, ...) — explicit column definitions
                cols = []
                while True:
                    cname = self.identifier()
                    cols.append((cname, self._type_name()))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                return t.CreateTable(
                    name=name, columns=tuple(cols), if_not_exists=if_not_exists
                )
            self.expect_keyword("AS")
            query = self.parse_query()
            return t.CreateTableAsSelect(name=name, query=query, if_not_exists=if_not_exists)
        if self.at_keyword("GRANT", "REVOKE"):
            is_grant = self.advance().value == "GRANT"
            privs: List[str] = []
            if self.accept_keyword("ALL"):
                self.accept_keyword("PRIVILEGES")
            else:
                while True:
                    privs.append(self.advance().value.upper())
                    if not self.accept_op(","):
                        break
            self.expect_keyword("ON")
            self.accept_keyword("TABLE")
            table = self.qualified_name()
            self.expect_keyword("TO" if is_grant else "FROM")
            self.accept_keyword("USER")
            grantee = self.identifier()
            cls = t.Grant if is_grant else t.Revoke
            return cls(privileges=tuple(privs), table=table, grantee=grantee)
        if self.accept_keyword("DROP"):
            if self.accept_keyword("FUNCTION"):
                if_exists = False
                if self.accept_keyword("IF"):
                    self.expect_keyword("EXISTS")
                    if_exists = True
                return t.DropFunction(name=self.qualified_name(), if_exists=if_exists)
            if self.accept_keyword("VIEW"):
                if_exists = False
                if self.accept_keyword("IF"):
                    self.expect_keyword("EXISTS")
                    if_exists = True
                return t.DropView(name=self.qualified_name(), if_exists=if_exists)
            self.expect_keyword("TABLE")
            if_exists = False
            if self.accept_keyword("IF"):
                self.expect_keyword("EXISTS")
                if_exists = True
            return t.DropTable(name=self.qualified_name(), if_exists=if_exists)
        if self.accept_keyword("INSERT"):
            self.expect_keyword("INTO")
            name = self.qualified_name()
            cols: Tuple[str, ...] = ()
            if self.at_op("(") and self._looks_like_column_list():
                self.expect_op("(")
                names = [self.identifier()]
                while self.accept_op(","):
                    names.append(self.identifier())
                self.expect_op(")")
                cols = tuple(names)
            query = self.parse_query()
            return t.InsertInto(table=name, columns=cols, query=query)
        if self.accept_keyword("DESCRIBE"):
            if self.accept_keyword("INPUT"):
                return t.DescribeInput(name=self.identifier())
            if self.accept_keyword("OUTPUT"):
                return t.DescribeOutput(name=self.identifier())
            return t.ShowColumns(table=self.qualified_name())
        if self.accept_keyword("PREPARE"):
            name = self.identifier()
            self.expect_keyword("FROM")
            body_start = self.peek().pos
            stmt = self._statement()
            body = self.sql[body_start:].strip().rstrip(";").strip()
            return t.Prepare(name=name, statement=stmt, body_text=body)
        if self.accept_keyword("EXECUTE"):
            name = self.identifier()
            params: List[t.Expression] = []
            if self.accept_keyword("USING"):
                params.append(self.expression())
                while self.accept_op(","):
                    params.append(self.expression())
            return t.ExecuteStmt(name=name, parameters=tuple(params))
        if self.accept_keyword("DEALLOCATE"):
            self.accept_keyword("PREPARE")
            return t.Deallocate(name=self.identifier())
        if self.accept_keyword("DELETE"):
            self.expect_keyword("FROM")
            name = self.qualified_name()
            where = self.expression() if self.accept_keyword("WHERE") else None
            return t.Delete(table=name, where=where)
        if self.accept_keyword("UPDATE"):
            name = self.qualified_name()
            self.expect_keyword("SET")
            assignments = [self._update_assignment()]
            while self.accept_op(","):
                assignments.append(self._update_assignment())
            where = self.expression() if self.accept_keyword("WHERE") else None
            return t.Update(table=name, assignments=tuple(assignments), where=where)
        if self.accept_keyword("MERGE"):
            return self._merge()
        if self.accept_keyword("START"):
            self.expect_keyword("TRANSACTION")
            read_only = False
            isolation = "SERIALIZABLE"
            while True:
                self.accept_op(",")
                if self.accept_keyword("ISOLATION"):
                    self.expect_keyword("LEVEL")
                    if self.accept_keyword("SERIALIZABLE"):
                        isolation = "SERIALIZABLE"
                    elif self.accept_keyword("REPEATABLE"):
                        self.expect_keyword("READ")
                        isolation = "REPEATABLE READ"
                    elif self.accept_keyword("READ"):
                        if self.accept_keyword("COMMITTED"):
                            isolation = "READ COMMITTED"
                        else:
                            self.expect_keyword("UNCOMMITTED")
                            isolation = "READ UNCOMMITTED"
                    else:
                        raise ParseError(
                            f"expected isolation level at {self.peek().pos}"
                        )
                elif self.accept_keyword("READ"):
                    if self.accept_keyword("ONLY"):
                        read_only = True
                    else:
                        self.expect_keyword("WRITE")
                        read_only = False
                else:
                    break
            return t.StartTransaction(read_only=read_only, isolation=isolation)
        if self.accept_keyword("COMMIT"):
            self.accept_keyword("WORK")
            return t.Commit()
        if self.accept_keyword("ROLLBACK"):
            self.accept_keyword("WORK")
            return t.Rollback()
        # CALL lexes as a plain identifier (not in KEYWORDS); only treat it
        # as a statement head when followed by a procedure name
        if (
            self.peek().type == TokenType.IDENT
            and self.peek().value == "call"
            and self.peek(1).type in (TokenType.IDENT, TokenType.QUOTED_IDENT)
        ):
            self.advance()  # CALL
            name = self.qualified_name()
            self.expect_op("(")
            args: List[t.Expression] = []
            if not self.accept_op(")"):
                args.append(self.expression())
                while self.accept_op(","):
                    args.append(self.expression())
                self.expect_op(")")
            return t.Call(name=name, arguments=tuple(args))
        return t.QueryStatement(query=self.parse_query())

    def _update_assignment(self):
        col = self.identifier()
        self.expect_op("=")
        return (col, self.expression())

    def _merge(self) -> t.Statement:
        self.expect_keyword("INTO")
        target = self.qualified_name()
        target_alias = None
        if self.accept_keyword("AS"):
            target_alias = self.identifier()
        elif self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT) and not self.at_keyword("USING"):
            target_alias = self.identifier()
        self.expect_keyword("USING")
        source = self._relation()
        self.expect_keyword("ON")
        on = self.expression()
        cases = []
        while self.at_keyword("WHEN"):
            self.expect_keyword("WHEN")
            matched = True
            if self.accept_keyword("NOT"):
                matched = False
            self.expect_keyword("MATCHED")
            condition = None
            if self.accept_keyword("AND"):
                condition = self.expression()
            self.expect_keyword("THEN")
            if self.accept_keyword("UPDATE"):
                self.expect_keyword("SET")
                assignments = [self._update_assignment()]
                while self.accept_op(","):
                    assignments.append(self._update_assignment())
                cases.append(
                    t.MergeCase(matched, condition, "update", tuple(assignments))
                )
            elif self.accept_keyword("DELETE"):
                cases.append(t.MergeCase(matched, condition, "delete"))
            else:
                self.expect_keyword("INSERT")
                cols: list = []
                if self.accept_op("("):
                    cols.append(self.identifier())
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                self.expect_keyword("VALUES")
                self.expect_op("(")
                values = [self.expression()]
                while self.accept_op(","):
                    values.append(self.expression())
                self.expect_op(")")
                cases.append(
                    t.MergeCase(
                        matched, condition, "insert",
                        insert_columns=tuple(cols), insert_values=tuple(values),
                    )
                )
        if not cases:
            raise ParseError("MERGE requires at least one WHEN clause")
        return t.Merge(
            target=target, target_alias=target_alias, source=source, on=on,
            cases=tuple(cases),
        )

    def _looks_like_column_list(self) -> bool:
        # distinguish INSERT INTO t (a, b) SELECT ... from INSERT INTO t (SELECT ...)
        i = self.pos + 1
        tok = self.tokens[i]
        return tok.type in (TokenType.IDENT, TokenType.QUOTED_IDENT) or (
            tok.type == TokenType.KEYWORD and tok.value in NON_RESERVED
        )

    def _show(self) -> t.Statement:
        self.expect_keyword("SHOW")
        if self.accept_keyword("FUNCTIONS"):
            return t.ShowFunctions()
        if self.accept_keyword("TABLES"):
            schema = None
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                schema = self.qualified_name()
            return t.ShowTables(schema=schema)
        if self.accept_keyword("SCHEMAS"):
            catalog = None
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                catalog = self.identifier()
            return t.ShowSchemas(catalog=catalog)
        if self.accept_keyword("CATALOGS"):
            return t.ShowCatalogs()
        if self.accept_keyword("COLUMNS"):
            if not (self.accept_keyword("FROM") or self.accept_keyword("IN")):
                raise ParseError("expected FROM after SHOW COLUMNS")
            return t.ShowColumns(table=self.qualified_name())
        if self.accept_keyword("SESSION"):
            return t.ShowSession()
        if self.accept_keyword("CREATE"):
            if self.accept_keyword("VIEW"):
                return t.ShowCreate(kind="view", name=self.qualified_name())
            self.expect_keyword("TABLE")
            return t.ShowCreate(kind="table", name=self.qualified_name())
        raise ParseError(f"unsupported SHOW statement at {self.peek().pos}")

    # ------------------------------------------------------------------ query

    def parse_query(self) -> t.Query:
        with_queries: Tuple[t.WithQuery, ...] = ()
        if self.accept_keyword("WITH"):
            items = [self._with_query()]
            while self.accept_op(","):
                items.append(self._with_query())
            with_queries = tuple(items)
        body = self._query_term()
        order_by, limit, offset = self._order_limit()
        # If the body is a bare QuerySpecification, fold ORDER BY/LIMIT into it
        # (matches Trino's queryNoWith handling, AstBuilder.java visitQueryNoWith).
        if isinstance(body, t.QuerySpecification) and (order_by or limit is not None or offset):
            body = t.QuerySpecification(
                select_items=body.select_items,
                distinct=body.distinct,
                from_=body.from_,
                where=body.where,
                group_by=body.group_by,
                having=body.having,
                order_by=order_by,
                limit=limit,
                offset=offset,
            )
            return t.Query(body=body, with_queries=with_queries)
        return t.Query(body=body, with_queries=with_queries, order_by=order_by, limit=limit, offset=offset)

    def _with_query(self) -> t.WithQuery:
        name = self.identifier()
        cols: Tuple[str, ...] = ()
        if self.accept_op("("):
            names = [self.identifier()]
            while self.accept_op(","):
                names.append(self.identifier())
            self.expect_op(")")
            cols = tuple(names)
        self.expect_keyword("AS")
        self.expect_op("(")
        q = self.parse_query()
        self.expect_op(")")
        return t.WithQuery(name=name, query=q, column_names=cols)

    def _order_limit(self):
        order_by: Tuple[t.SortItem, ...] = ()
        limit: Optional[int] = None
        offset = 0
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            items = [self._sort_item()]
            while self.accept_op(","):
                items.append(self._sort_item())
            order_by = tuple(items)
        # OFFSET/LIMIT accepted in either order (Trino uses OFFSET-then-LIMIT;
        # the Postgres/MySQL LIMIT-then-OFFSET spelling is ubiquitous), but each
        # clause kind at most once
        seen_offset = seen_limit = False
        for _ in range(2):
            if self.at_keyword("OFFSET"):
                if seen_offset:
                    raise ParseError(f"duplicate OFFSET at {self.peek().pos}")
                seen_offset = True
                self.advance()
                offset = int(self.advance().value)
                self.accept_keyword("ROWS") or self.accept_keyword("ROW")
            elif self.at_keyword("LIMIT", "FETCH"):
                if seen_limit:
                    raise ParseError(f"duplicate LIMIT/FETCH at {self.peek().pos}")
                seen_limit = True
                if self.accept_keyword("LIMIT"):
                    tok = self.advance()
                    if tok.type == TokenType.KEYWORD and tok.value == "ALL":
                        limit = None
                    else:
                        limit = int(tok.value)
                else:
                    self.expect_keyword("FETCH")
                    self.accept_keyword("FIRST") or self.accept_keyword("NEXT")
                    limit = int(self.advance().value)
                    self.accept_keyword("ROWS") or self.accept_keyword("ROW")
                    self.expect_keyword("ONLY")
        return order_by, limit, offset

    def _sort_item(self) -> t.SortItem:
        key = self.expression()
        ascending = True
        if self.accept_keyword("ASC"):
            pass
        elif self.accept_keyword("DESC"):
            ascending = False
        nulls_first: Optional[bool] = None
        if self.accept_keyword("NULLS"):
            if self.accept_keyword("FIRST"):
                nulls_first = True
            else:
                self.expect_keyword("LAST")
                nulls_first = False
        return t.SortItem(key=key, ascending=ascending, nulls_first=nulls_first)

    def _query_term(self) -> t.QueryBody:
        left = self._query_primary()
        while self.at_keyword("UNION", "INTERSECT", "EXCEPT"):
            op_tok = self.advance().value
            distinct = True
            if self.accept_keyword("ALL"):
                distinct = False
            else:
                self.accept_keyword("DISTINCT")
            right = self._query_primary()
            left = t.SetOperation(op=t.SetOpType[op_tok], left=left, right=right, distinct=distinct)
        return left

    def _query_primary(self) -> t.QueryBody:
        if self.at_keyword("SELECT"):
            return self._query_specification()
        if self.accept_keyword("VALUES"):
            rows = [self.expression()]
            while self.accept_op(","):
                rows.append(self.expression())
            return t.Values(rows=tuple(rows))
        if self.accept_keyword("TABLE"):
            return t.TableRef(name=self.qualified_name())
        if self.accept_op("("):
            q = self.parse_query()
            self.expect_op(")")
            # flatten: (query) as a query body
            if not q.with_queries and not q.order_by and q.limit is None and not q.offset:
                return q.body
            # keep as subquery spec via a wrapper table subquery in FROM-less select
            return q.body
        raise ParseError(f"expected query at {self.peek().pos}, found {self.peek().value!r}")

    def _query_specification(self) -> t.QuerySpecification:
        self.expect_keyword("SELECT")
        distinct = False
        if self.accept_keyword("DISTINCT"):
            distinct = True
        else:
            self.accept_keyword("ALL")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_: Optional[t.Relation] = None
        if self.accept_keyword("FROM"):
            from_ = self._relation()
            while self.accept_op(","):
                right = self._relation()
                from_ = t.Join(join_type=t.JoinType.IMPLICIT, left=from_, right=right)
        where = self.expression() if self.accept_keyword("WHERE") else None
        group_by: Tuple[t.GroupingElement, ...] = ()
        if self.accept_keyword("GROUP"):
            self.expect_keyword("BY")
            group_by = tuple(self._grouping_elements())
        having = self.expression() if self.accept_keyword("HAVING") else None
        return t.QuerySpecification(
            select_items=tuple(items),
            distinct=distinct,
            from_=from_,
            where=where,
            group_by=group_by,
            having=having,
        )

    def _grouping_elements(self) -> List[t.GroupingElement]:
        elements = []
        while True:
            if self.accept_keyword("ROLLUP"):
                self.expect_op("(")
                exprs = [self.expression()]
                while self.accept_op(","):
                    exprs.append(self.expression())
                self.expect_op(")")
                elements.append(t.GroupingElement(tuple(exprs), kind="rollup"))
            elif self.accept_keyword("CUBE"):
                self.expect_op("(")
                exprs = [self.expression()]
                while self.accept_op(","):
                    exprs.append(self.expression())
                self.expect_op(")")
                elements.append(t.GroupingElement(tuple(exprs), kind="cube"))
            elif self.at_keyword("GROUPING") and self.peek(1).value == "SETS":
                self.advance()
                self.advance()
                self.expect_op("(")
                # each set is (a, b) or a
                sets = []
                while True:
                    if self.accept_op("("):
                        exprs = []
                        if not self.at_op(")"):
                            exprs.append(self.expression())
                            while self.accept_op(","):
                                exprs.append(self.expression())
                        self.expect_op(")")
                        sets.append(tuple(exprs))
                    else:
                        sets.append((self.expression(),))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                union_exprs = tuple(e for s in sets for e in s)
                elements.append(
                    t.GroupingElement(union_exprs, kind="grouping_sets", sets=tuple(sets))
                )
            else:
                elements.append(t.GroupingElement((self.expression(),), kind="simple"))
            if not self.accept_op(","):
                break
        return elements

    def _select_item(self) -> t.SelectItem:
        if self.at_op("*"):
            self.advance()
            return t.SelectItem(expression=t.Star())
        # t.* / catalog.schema.t.*
        save = self.pos
        try:
            qn = self.qualified_name()
            if self.at_op(".") and self.peek(1).type == TokenType.OP and self.peek(1).value == "*":
                self.advance()
                self.advance()
                return t.SelectItem(expression=t.Star(qualifier=qn))
        except ParseError:
            pass
        self.pos = save
        expr = self.expression()
        alias = None
        if self.accept_keyword("AS"):
            alias = self.identifier()
        elif self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT):
            alias = self.identifier()
        return t.SelectItem(expression=expr, alias=alias)

    # -------------------------------------------------------------- relations

    def _relation(self) -> t.Relation:
        left = self._sampled_relation()
        while True:
            if self.accept_keyword("CROSS"):
                self.expect_keyword("JOIN")
                right = self._sampled_relation()
                left = t.Join(join_type=t.JoinType.CROSS, left=left, right=right)
                continue
            natural = self.accept_keyword("NATURAL")
            jt: Optional[t.JoinType] = None
            if self.accept_keyword("JOIN"):
                jt = t.JoinType.INNER
            elif self.accept_keyword("INNER"):
                self.expect_keyword("JOIN")
                jt = t.JoinType.INNER
            elif self.at_keyword("LEFT", "RIGHT", "FULL"):
                side = self.advance().value
                self.accept_keyword("OUTER")
                self.expect_keyword("JOIN")
                jt = t.JoinType[side]
            elif natural:
                raise ParseError("expected JOIN after NATURAL")
            if jt is None:
                return left
            right = self._sampled_relation()
            criteria: Optional[t.Node]
            if natural:
                criteria = t.NaturalJoin()
            elif self.accept_keyword("ON"):
                criteria = t.JoinOn(self.expression())
            elif self.accept_keyword("USING"):
                self.expect_op("(")
                cols = [self.identifier()]
                while self.accept_op(","):
                    cols.append(self.identifier())
                self.expect_op(")")
                criteria = t.JoinUsing(tuple(cols))
            else:
                raise ParseError(f"expected ON or USING for join at {self.peek().pos}")
            left = t.Join(join_type=jt, left=left, right=right, criteria=criteria)

    def _sampled_relation(self) -> t.Relation:
        rel = self._aliased_relation()
        # patternRecognition sits ABOVE aliasedRelation in SqlBase.g4: the
        # MATCH_RECOGNIZE suffix applies to the aliased input, and its result
        # may itself be aliased
        if self.accept_keyword("MATCH_RECOGNIZE"):
            rel = self._match_recognize(rel)
            rel = self._maybe_alias(rel)
        return rel

    def _aliased_relation(self) -> t.Relation:
        return self._maybe_alias(self._relation_primary())

    def _maybe_alias(self, rel: t.Relation) -> t.Relation:
        alias = None
        cols: Tuple[str, ...] = ()
        if self.accept_keyword("AS"):
            alias = self.identifier()
        elif self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT) and not self.at_keyword():
            alias = self.identifier()
        if alias is not None:
            if self.accept_op("("):
                names = [self.identifier()]
                while self.accept_op(","):
                    names.append(self.identifier())
                self.expect_op(")")
                cols = tuple(names)
            return t.AliasedRelation(relation=rel, alias=alias, column_names=cols)
        return rel

    def _create_function(self, replace: bool) -> t.Statement:
        """CREATE [OR REPLACE] FUNCTION name(p type, ...) RETURNS type
        [DETERMINISTIC] RETURN expr (sql/tree/CreateFunction.java; the
        expression-bodied routine subset)."""
        name = self.qualified_name()
        self.expect_op("(")
        params: List[Tuple[str, str]] = []
        if not self.at_op(")"):
            while True:
                pname = self.identifier()
                params.append((pname, self._type_name()))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        self.expect_keyword("RETURNS")
        return_type = self._type_name()
        self.accept_keyword("DETERMINISTIC")
        self.expect_keyword("RETURN")
        body_start = self.peek().pos
        body = self.expression()
        return t.CreateFunction(
            name=name,
            parameters=tuple(params),
            return_type=return_type,
            body=body,
            body_text=self.sql[body_start:].strip().rstrip(";").strip(),
            replace=replace,
        )

    def _match_recognize(self, rel: t.Relation) -> t.Relation:
        """MATCH_RECOGNIZE (...) suffix (ref: patternRecognition rule in
        SqlBase.g4 + sql/tree/PatternRecognitionRelation.java)."""
        self.expect_op("(")
        partition: list = []
        order: list = []
        measures: list = []
        rows_per_match = "ONE"
        skip = t.SkipTo()
        subsets: list = []
        defines: list = []
        if self.accept_keyword("PARTITION"):
            self.expect_keyword("BY")
            partition.append(self.expression())
            while self.accept_op(","):
                partition.append(self.expression())
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            order.append(self._sort_item())
            while self.accept_op(","):
                order.append(self._sort_item())
        if self.accept_keyword("MEASURES"):
            while True:
                semantics = None
                tok = self.peek()
                if tok.type == TokenType.IDENT and tok.value in ("running", "final"):
                    semantics = tok.value.upper()
                    self.advance()
                expr = self.expression()
                self.expect_keyword("AS")
                measures.append(
                    t.MeasureItem(
                        expression=expr, name=self.identifier(), semantics=semantics
                    )
                )
                if not self.accept_op(","):
                    break
        if self.accept_keyword("ONE"):
            self.expect_keyword("ROW")
            self.expect_keyword("PER")
            self.expect_keyword("MATCH")
        elif self.accept_keyword("ALL"):
            self.expect_keyword("ROWS")
            self.expect_keyword("PER")
            self.expect_keyword("MATCH")
            rows_per_match = "ALL"
            if self.accept_keyword("OMIT"):  # OMIT EMPTY MATCHES (the default)
                self.expect_keyword("EMPTY")
                self.accept_keyword("MATCHES")
        if self.accept_keyword("AFTER"):
            self.expect_keyword("MATCH")
            self.expect_keyword("SKIP")
            if self.accept_keyword("PAST"):
                self.expect_keyword("LAST")
                self.expect_keyword("ROW")
                skip = t.SkipTo(mode="PAST_LAST")
            else:
                self.expect_keyword("TO")
                if self.accept_keyword("NEXT"):
                    self.expect_keyword("ROW")
                    skip = t.SkipTo(mode="TO_NEXT_ROW")
                elif self.accept_keyword("FIRST"):
                    skip = t.SkipTo(mode="TO_FIRST", target=self.identifier())
                else:
                    self.accept_keyword("LAST")
                    skip = t.SkipTo(mode="TO_LAST", target=self.identifier())
        self.expect_keyword("PATTERN")
        self.expect_op("(")
        pattern = self._row_pattern()
        self.expect_op(")")
        if self.accept_keyword("SUBSET"):
            while True:
                name = self.identifier()
                self.expect_op("=")
                self.expect_op("(")
                members = [self.identifier()]
                while self.accept_op(","):
                    members.append(self.identifier())
                self.expect_op(")")
                subsets.append((name, tuple(members)))
                if not self.accept_op(","):
                    break
        self.expect_keyword("DEFINE")
        while True:
            var = self.identifier()
            self.expect_keyword("AS")
            defines.append((var, self.expression()))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return t.MatchRecognize(
            relation=rel,
            partition_by=tuple(partition),
            order_by=tuple(order),
            measures=tuple(measures),
            rows_per_match=rows_per_match,
            after_skip=skip,
            pattern=pattern,
            subsets=tuple(subsets),
            defines=tuple(defines),
        )

    def _row_pattern(self) -> t.Node:
        """alternation > concatenation > quantified primary (SqlBase.g4
        rowPattern / patternTerm / patternPrimary)."""
        alts = [self._row_pattern_concat()]
        while self.accept_op("|"):
            alts.append(self._row_pattern_concat())
        if len(alts) == 1:
            return alts[0]
        return t.PatternAlternation(alternatives=tuple(alts))

    def _row_pattern_concat(self) -> t.Node:
        elems = [self._row_pattern_quantified()]
        while (
            self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT)
            or self.at_op("(")
        ):
            elems.append(self._row_pattern_quantified())
        if len(elems) == 1:
            return elems[0]
        return t.PatternConcatenation(elements=tuple(elems))

    def _row_pattern_quantified(self) -> t.Node:
        if self.accept_op("("):
            elem: t.Node = self._row_pattern()
            self.expect_op(")")
        else:
            elem = t.PatternVariable(name=self.identifier())
        lo: Optional[int] = None
        hi: Optional[int] = None
        if self.accept_op("*"):
            lo, hi = 0, None
        elif self.accept_op("+"):
            lo, hi = 1, None
        elif self.accept_op("?"):
            lo, hi = 0, 1
        elif self.accept_op("{"):
            if self.accept_op(","):
                lo = 0
                hi = int(self.advance().value)
            else:
                lo = int(self.advance().value)
                if self.accept_op(","):
                    hi = None if self.at_op("}") else int(self.advance().value)
                else:
                    hi = lo
            self.expect_op("}")
        if lo is None:
            return elem
        greedy = not self.accept_op("?")
        return t.PatternQuantified(element=elem, min=lo, max=hi, greedy=greedy)

    def _relation_primary(self) -> t.Relation:
        if self.accept_keyword("LATERAL"):
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return t.Lateral(query=q)
        if self.accept_keyword("UNNEST"):
            self.expect_op("(")
            exprs = [self.expression()]
            while self.accept_op(","):
                exprs.append(self.expression())
            self.expect_op(")")
            with_ord = False
            if self.accept_keyword("WITH"):
                self.expect_keyword("ORDINALITY")
                with_ord = True
            return t.Unnest(expressions=tuple(exprs), with_ordinality=with_ord)
        if (
            self.at_keyword("TABLE")
            and self.peek(1).type == TokenType.OP
            and self.peek(1).value == "("
        ):
            # table function invocation: TABLE(sequence(1, 10)) or the
            # polymorphic form TABLE(exclude_columns(input => TABLE(orders),
            # columns => DESCRIPTOR(o_comment)))
            self.advance()
            self.expect_op("(")
            name = self.qualified_name()
            self.expect_op("(")
            args: List[t.Expression] = []
            named: List[tuple] = []

            def tf_argument():
                if self.at_keyword("TABLE"):
                    self.advance()
                    self.expect_op("(")
                    if self.at_keyword("SELECT", "WITH", "VALUES"):
                        rel = t.TableSubquery(query=self.parse_query())
                    else:
                        rel = t.Table(name=self.qualified_name())
                    self.expect_op(")")
                    return rel
                if (
                    self.at_keyword("DESCRIPTOR")
                    or (
                        self.peek().type == TokenType.IDENT
                        and self.peek().value.lower() == "descriptor"
                        and self.peek(1).type == TokenType.OP
                        and self.peek(1).value == "("
                    )
                ):
                    self.advance()
                    self.expect_op("(")
                    cols = [self.identifier()]
                    while self.accept_op(","):
                        cols.append(self.identifier())
                    self.expect_op(")")
                    return t.Descriptor(columns=tuple(str(c).lower() for c in cols))
                return self.expression()

            if not self.at_op(")"):
                while True:
                    if (
                        self.peek().type
                        in (TokenType.IDENT, TokenType.QUOTED_IDENT, TokenType.KEYWORD)
                        and self.peek(1).type == TokenType.OP
                        and self.peek(1).value == "=>"
                    ):
                        arg_name = str(self.identifier()).lower()
                        self.expect_op("=>")
                        named.append((arg_name, tf_argument()))
                    else:
                        args.append(tf_argument())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            self.expect_op(")")
            return t.TableFunctionRelation(
                name=str(name).lower(), args=tuple(args), named_args=tuple(named)
            )
        if self.accept_op("("):
            # subquery or parenthesized relation
            if self.at_keyword("SELECT", "WITH", "VALUES", "TABLE"):
                q = self.parse_query()
                self.expect_op(")")
                return t.TableSubquery(query=q)
            if self.at_op("("):
                # ambiguous: "((" starts either a nested subquery or a
                # parenthesized JOIN chain like ((a JOIN b) JOIN c) —
                # backtrack on failure (SqlBase.g4 resolves via
                # aliasedRelation | subquery alternatives)
                saved = self.pos
                try:
                    q = self.parse_query()
                    self.expect_op(")")
                    return t.TableSubquery(query=q)
                except ParseError:
                    self.pos = saved
            rel = self._relation()
            self.expect_op(")")
            return rel
        name = self.qualified_name()
        version = None
        if (
            self.at_keyword("FOR")
            and self.peek(1).type == TokenType.IDENT
            and self.peek(1).value == "version"
        ):
            # FOR VERSION AS OF <n> (time travel; ref: SqlBase.g4 queryPeriod)
            self.advance()  # FOR
            self.advance()  # version (plain identifier; not in KEYWORDS)
            self.expect_keyword("AS")
            ident = self.identifier()
            if ident != "of":
                raise ParseError(f"expected OF in FOR VERSION AS OF, found {ident!r}")
            tok = self.peek()
            if tok.type != TokenType.INTEGER:
                raise ParseError(f"FOR VERSION AS OF expects an integer at {tok.pos}")
            self.advance()
            version = int(tok.value)
        return t.Table(name=name, version=version)

    # ------------------------------------------------------------ expressions

    def expression(self) -> t.Expression:
        return self._or_expr()

    def _or_expr(self) -> t.Expression:
        terms = [self._and_expr()]
        while self.accept_keyword("OR"):
            terms.append(self._and_expr())
        return terms[0] if len(terms) == 1 else t.Logical("OR", tuple(terms))

    def _and_expr(self) -> t.Expression:
        terms = [self._not_expr()]
        while self.accept_keyword("AND"):
            terms.append(self._not_expr())
        return terms[0] if len(terms) == 1 else t.Logical("AND", tuple(terms))

    def _not_expr(self) -> t.Expression:
        if self.accept_keyword("NOT"):
            return t.Not(self._not_expr())
        return self._predicate()

    def _predicate(self) -> t.Expression:
        expr = self._value_expr()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op_text = self.advance().value
                if op_text == "!=":
                    op_text = "<>"
                right = self._value_expr()
                expr = t.Comparison(t.ComparisonOp(op_text), expr, right)
                continue
            if self.at_keyword("IS"):
                self.advance()
                negated = self.accept_keyword("NOT")
                if self.accept_keyword("NULL"):
                    expr = t.IsNotNull(expr) if negated else t.IsNull(expr)
                elif self.accept_keyword("DISTINCT"):
                    self.expect_keyword("FROM")
                    right = self._value_expr()
                    cmp = t.Comparison(t.ComparisonOp.IS_DISTINCT_FROM, expr, right)
                    expr = t.Not(cmp) if negated else cmp
                elif self.at_keyword("TRUE", "FALSE"):
                    val = self.advance().value == "TRUE"
                    cmp = t.Comparison(t.ComparisonOp.EQUAL, expr, t.BooleanLiteral(val))
                    # IS TRUE: null -> false (differs from = NULL semantics); round 1
                    # approximates with coalesce at analysis time.
                    expr = t.Not(cmp) if negated else cmp
                else:
                    raise ParseError(f"unsupported IS predicate at {self.peek().pos}")
                continue
            negated = False
            save = self.pos
            if self.accept_keyword("NOT"):
                negated = True
            if self.accept_keyword("BETWEEN"):
                lo = self._value_expr()
                self.expect_keyword("AND")
                hi = self._value_expr()
                expr = t.Between(expr, lo, hi, negated=negated)
                continue
            if self.accept_keyword("IN"):
                self.expect_op("(")
                if self.at_keyword("SELECT", "WITH"):
                    q = self.parse_query()
                    self.expect_op(")")
                    expr = t.InSubquery(expr, q, negated=negated)
                else:
                    items = [self.expression()]
                    while self.accept_op(","):
                        items.append(self.expression())
                    self.expect_op(")")
                    expr = t.InList(expr, tuple(items), negated=negated)
                continue
            if self.accept_keyword("LIKE"):
                pattern = self._value_expr()
                escape = None
                if self.accept_keyword("ESCAPE"):
                    escape = self._value_expr()
                expr = t.Like(expr, pattern, escape=escape, negated=negated)
                continue
            if negated:
                self.pos = save
            break
        return expr

    def _value_expr(self) -> t.Expression:
        return self._additive()

    def _additive(self) -> t.Expression:
        expr = self._multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.advance().value
                right = self._multiplicative()
                aop = t.ArithmeticOp.ADD if op == "+" else t.ArithmeticOp.SUBTRACT
                expr = t.ArithmeticBinary(aop, expr, right)
            elif self.at_op("||"):
                self.advance()
                right = self._multiplicative()
                expr = t.FunctionCall(t.QualifiedName(("concat",)), (expr, right))
            else:
                return expr

    def _multiplicative(self) -> t.Expression:
        expr = self._unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            right = self._unary()
            aop = {
                "*": t.ArithmeticOp.MULTIPLY,
                "/": t.ArithmeticOp.DIVIDE,
                "%": t.ArithmeticOp.MODULUS,
            }[op]
            expr = t.ArithmeticBinary(aop, expr, right)
        return expr

    def _unary(self) -> t.Expression:
        if self.at_op("-"):
            self.advance()
            return t.ArithmeticUnary("-", self._unary())
        if self.at_op("+"):
            self.advance()
            return self._unary()
        expr = self._primary()
        while self.at_op("["):  # postfix subscript: a[1], m['k'], nested a[1][2]
            self.advance()
            idx = self.expression()
            self.expect_op("]")
            expr = t.Subscript(base=expr, index=idx)
        return expr

    def _primary(self) -> t.Expression:
        tok = self.peek()
        # literals
        if tok.type == TokenType.INTEGER:
            self.advance()
            return t.LongLiteral(int(tok.value))
        if tok.type == TokenType.DECIMAL:
            self.advance()
            return t.DecimalLiteral(tok.value)
        if tok.type == TokenType.FLOAT:
            self.advance()
            return t.DoubleLiteral(float(tok.value))
        if tok.type == TokenType.STRING:
            self.advance()
            return t.StringLiteral(tok.value)
        if self.at_keyword("TRUE"):
            self.advance()
            return t.BooleanLiteral(True)
        if self.at_keyword("FALSE"):
            self.advance()
            return t.BooleanLiteral(False)
        if self.at_keyword("NULL"):
            self.advance()
            return t.NullLiteral()
        if self.at_keyword("DATE") and self.peek(1).type == TokenType.STRING:
            self.advance()
            return t.DateLiteral(self.advance().value)
        if (
            (self.at_keyword("DECIMAL")
             or (tok.type == TokenType.IDENT and tok.value.lower() == "decimal"))
            and self.peek(1).type == TokenType.STRING
        ):
            # DECIMAL 'x.y' typed literal (SqlBase.g4 typeConstructor)
            self.advance()
            text = self.advance().value
            return t.DecimalLiteral(text=text)
        if self.at_keyword("TIMESTAMP") and self.peek(1).type == TokenType.STRING:
            self.advance()
            return t.TimestampLiteral(self.advance().value)
        if self.at_keyword("TIME") and self.peek(1).type == TokenType.STRING:
            self.advance()
            return t.TimeLiteral(self.advance().value)
        if self.at_keyword("INTERVAL"):
            self.advance()
            sign = 1
            if self.accept_op("-"):
                sign = -1
            else:
                self.accept_op("+")
            value = self.advance().value  # string literal
            unit = self.advance().value.lower()
            return t.IntervalLiteral(value=value, unit=unit, sign=sign)
        if self.at_keyword("CURRENT_DATE"):
            self.advance()
            return t.CurrentDate()
        if self.at_keyword("GROUPING") and self.peek(1).value == "(":
            # GROUPING(key, ...) — grouping-set membership bitmask
            # (sql/tree/GroupingOperation.java); folded per UNION branch by
            # the grouping-sets rewrite
            self.advance()
            self.expect_op("(")
            gargs = [self.expression()]
            while self.accept_op(","):
                gargs.append(self.expression())
            self.expect_op(")")
            return t.FunctionCall(t.QualifiedName(("grouping",)), tuple(gargs))
        if self.at_keyword("CASE"):
            return self._case()
        if self.at_keyword("CAST", "TRY_CAST"):
            safe = tok.value == "TRY_CAST"
            self.advance()
            self.expect_op("(")
            value = self.expression()
            self.expect_keyword("AS")
            type_name = self._type_name()
            self.expect_op(")")
            return t.Cast(value=value, type_name=type_name, safe=safe)
        if self.at_keyword("EXTRACT"):
            self.advance()
            self.expect_op("(")
            field_tok = self.advance().value
            self.expect_keyword("FROM")
            value = self.expression()
            self.expect_op(")")
            return t.Extract(field_name=field_tok.upper(), value=value)
        if self.at_keyword("SUBSTRING"):
            # SUBSTRING(x FROM start [FOR length]) — also accepts function form
            self.advance()
            self.expect_op("(")
            value = self.expression()
            if self.accept_keyword("FROM"):
                start = self.expression()
                args = [value, start]
                if self.accept_keyword("FOR"):
                    args.append(self.expression())
                self.expect_op(")")
                return t.FunctionCall(t.QualifiedName(("substring",)), tuple(args))
            args = [value]
            while self.accept_op(","):
                args.append(self.expression())
            self.expect_op(")")
            return t.FunctionCall(t.QualifiedName(("substring",)), tuple(args))
        if self.at_keyword("EXISTS"):
            self.advance()
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return t.Exists(query=q)
        if (
            tok.type in (TokenType.IDENT, TokenType.KEYWORD)
            and tok.value.upper() == "ARRAY"
            and self.peek(1).type == TokenType.OP
            and self.peek(1).value == "["
        ):
            self.advance()
            self.expect_op("[")
            items = []
            if not self.at_op("]"):
                items.append(self.expression())
                while self.accept_op(","):
                    items.append(self.expression())
            self.expect_op("]")
            return t.Array(items=tuple(items))
        if self.at_keyword("ROW"):
            self.advance()
            self.expect_op("(")
            items = [self.expression()]
            while self.accept_op(","):
                items.append(self.expression())
            self.expect_op(")")
            return t.Row(items=tuple(items))
        if self.at_op("(") and self._lambda_ahead():
            # (x, y) -> body
            self.expect_op("(")
            params = [self.identifier()]
            while self.accept_op(","):
                params.append(self.identifier())
            self.expect_op(")")
            self.expect_op("->")
            return t.Lambda(params=tuple(params), body=self.expression())
        if self.accept_op("("):
            if self.at_keyword("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return t.ScalarSubquery(query=q)
            expr = self.expression()
            if self.at_op(","):
                items = [expr]
                while self.accept_op(","):
                    items.append(self.expression())
                self.expect_op(")")
                return t.Row(items=tuple(items))
            self.expect_op(")")
            return expr
        if self.at_op("?"):
            self.advance()
            idx = self._param_count
            self._param_count += 1
            return t.Parameter(index=idx)
        # function call or column reference
        if tok.type in (TokenType.IDENT, TokenType.QUOTED_IDENT) or (
            tok.type == TokenType.KEYWORD and tok.value in NON_RESERVED
        ):
            if (
                self.peek(1).type == TokenType.OP
                and self.peek(1).value == "->"
            ):
                # x -> body
                param = self.identifier()
                self.expect_op("->")
                return t.Lambda(params=(param,), body=self.expression())
            qn = self.qualified_name()
            if self.at_op("("):
                return self._function_call(qn)
            # column reference: a or a.b.c -> Dereference chain
            expr: t.Expression = t.Identifier(qn.parts[0])
            for part in qn.parts[1:]:
                expr = t.Dereference(expr, part)
            return expr
        raise ParseError(f"unexpected token {tok.value!r} at {tok.pos}")

    def _lambda_ahead(self) -> bool:
        """Lookahead for ``( ident [, ident]* ) ->`` from an opening paren."""
        i = 1
        expect_ident = True
        while True:
            tok = self.peek(i)
            if expect_ident:
                # same token classes identifier() accepts (incl. non-reserved
                # keywords like day/position as parameter names)
                if tok.type not in (TokenType.IDENT, TokenType.QUOTED_IDENT) and not (
                    tok.type == TokenType.KEYWORD and tok.value in NON_RESERVED
                ):
                    return False
                expect_ident = False
            else:
                if tok.type != TokenType.OP:
                    return False
                if tok.value == ",":
                    expect_ident = True
                elif tok.value == ")":
                    nxt = self.peek(i + 1)
                    return nxt.type == TokenType.OP and nxt.value == "->"
                else:
                    return False
            i += 1

    def _case(self) -> t.Expression:
        self.expect_keyword("CASE")
        operand = None
        if not self.at_keyword("WHEN"):
            operand = self.expression()
        whens = []
        while self.accept_keyword("WHEN"):
            cond = self.expression()
            self.expect_keyword("THEN")
            result = self.expression()
            whens.append(t.WhenClause(cond, result))
        default = None
        if self.accept_keyword("ELSE"):
            default = self.expression()
        self.expect_keyword("END")
        if operand is not None:
            return t.SimpleCase(operand=operand, when_clauses=tuple(whens), default=default)
        return t.SearchedCase(when_clauses=tuple(whens), default=default)

    def _function_call(self, name: t.QualifiedName) -> t.Expression:
        self.expect_op("(")
        distinct = False
        is_star = False
        args: List[t.Expression] = []
        if self.accept_op("*"):
            is_star = True
        elif not self.at_op(")"):
            if self.accept_keyword("DISTINCT"):
                distinct = True
            else:
                self.accept_keyword("ALL")
            args.append(self.expression())
            while self.accept_op(","):
                args.append(self.expression())
        order_by: List[t.SortItem] = []
        if self.accept_keyword("ORDER"):
            # aggregate ordering: array_agg(x ORDER BY y DESC)
            self.expect_keyword("BY")
            order_by.append(self._sort_item())
            while self.accept_op(","):
                order_by.append(self._sort_item())
        self.expect_op(")")
        if self.accept_keyword("WITHIN"):
            # listagg(x, sep) WITHIN GROUP (ORDER BY y)
            self.expect_keyword("GROUP")
            self.expect_op("(")
            self.expect_keyword("ORDER")
            self.expect_keyword("BY")
            order_by.append(self._sort_item())
            while self.accept_op(","):
                order_by.append(self._sort_item())
            self.expect_op(")")
        filter_expr = None
        if self.at_keyword("FILTER"):
            self.advance()
            self.expect_op("(")
            self.expect_keyword("WHERE")
            filter_expr = self.expression()
            self.expect_op(")")
        null_treatment = None
        if self.accept_keyword("IGNORE"):
            self.expect_keyword("NULLS")
            null_treatment = "IGNORE"
        elif self.accept_keyword("RESPECT"):
            self.expect_keyword("NULLS")
            null_treatment = "RESPECT"
        window = None
        if self.accept_keyword("OVER"):
            window = self._window_spec()
        return t.FunctionCall(
            name=name,
            args=tuple(args),
            distinct=distinct,
            is_star=is_star,
            filter=filter_expr,
            window=window,
            order_by=tuple(order_by),
            null_treatment=null_treatment,
        )

    def _window_spec(self) -> t.WindowSpec:
        self.expect_op("(")
        partition_by: List[t.Expression] = []
        order_by: List[t.SortItem] = []
        frame = None
        if self.accept_keyword("PARTITION"):
            self.expect_keyword("BY")
            partition_by.append(self.expression())
            while self.accept_op(","):
                partition_by.append(self.expression())
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            order_by.append(self._sort_item())
            while self.accept_op(","):
                order_by.append(self._sort_item())
        if self.at_keyword("ROWS", "RANGE"):
            type_ = self.advance().value.upper()
            pos = self.peek().pos
            if self.accept_keyword("BETWEEN"):
                start_kind, start_value = self._frame_bound()
                self.expect_keyword("AND")
                end_kind, end_value = self._frame_bound()
            else:
                start_kind, start_value = self._frame_bound()
                end_kind, end_value = "CURRENT_ROW", None
                if start_kind in ("FOLLOWING", "UNBOUNDED_FOLLOWING"):
                    raise ParseError(
                        f"frame start cannot be FOLLOWING without BETWEEN at {pos}"
                    )
            # bound ordering (ref: WindowFrame validation in the analyzer):
            # start must not come after end in the kind ordering
            order = {
                "UNBOUNDED_PRECEDING": 0, "PRECEDING": 1, "CURRENT_ROW": 2,
                "FOLLOWING": 3, "UNBOUNDED_FOLLOWING": 4,
            }
            if (
                start_kind == "UNBOUNDED_FOLLOWING"
                or end_kind == "UNBOUNDED_PRECEDING"
                or order[start_kind] > order[end_kind]
            ):
                raise ParseError(f"invalid window frame bounds at {pos}")
            frame = t.WindowFrame(
                type_=type_,
                start_kind=start_kind,
                end_kind=end_kind,
                start_value=start_value,
                end_value=end_value,
            )
        self.expect_op(")")
        return t.WindowSpec(
            partition_by=tuple(partition_by), order_by=tuple(order_by), frame=frame
        )

    def _frame_bound(self):
        """UNBOUNDED PRECEDING/FOLLOWING | CURRENT ROW | <n> PRECEDING/FOLLOWING."""
        if self.accept_keyword("UNBOUNDED"):
            if self.accept_keyword("PRECEDING"):
                return "UNBOUNDED_PRECEDING", None
            self.expect_keyword("FOLLOWING")
            return "UNBOUNDED_FOLLOWING", None
        if self.accept_keyword("CURRENT"):
            self.expect_keyword("ROW")
            return "CURRENT_ROW", None
        if self.accept_keyword("INTERVAL"):
            # INTERVAL 'n' DAY bounds for date-ordered RANGE frames
            tk = self.advance()
            if tk.type != TokenType.STRING:
                raise ParseError(f"expected interval literal at {tk.pos}")
            value = int(tk.value)
            unit = self.advance().value.upper()
            if unit == "DAY":
                pass
            elif unit in ("MONTH", "YEAR"):
                raise ParseError(
                    f"only DAY intervals are supported in frame bounds at {tk.pos}"
                )
            else:
                raise ParseError(f"unexpected interval unit at {tk.pos}")
        else:
            tk = self.advance()
            if tk.type == TokenType.INTEGER:
                value = int(tk.value)
            elif tk.type in (TokenType.DECIMAL, TokenType.FLOAT):
                value = float(tk.value)
            else:
                raise ParseError(f"expected frame bound at {tk.pos}")
        if self.accept_keyword("PRECEDING"):
            return "PRECEDING", value
        self.expect_keyword("FOLLOWING")
        return "FOLLOWING", value

    def _type_name(self) -> str:
        base = self.advance().value.lower()
        if base == "double" and self.at_keyword():  # DOUBLE PRECISION
            if self.peek().value == "PRECISION":
                self.advance()
        text = base
        if self.accept_op("("):
            args = [self.advance().value]
            while self.accept_op(","):
                args.append(self.advance().value)
            self.expect_op(")")
            text = f"{base}({','.join(args)})"
        if (
            base in ("timestamp", "time")
            and self.at_keyword("WITH")
            and self.peek(1).value.upper() == "TIME"
            and self.peek(2).value.upper() == "ZONE"
        ):
            self.advance()
            self.advance()
            self.advance()
            text += " with time zone"
        return text


def parse_statement(sql: str) -> t.Statement:
    """Entry point (ref: parser/SqlParser.java:104 createStatement)."""
    return Parser(sql).parse_statement()


def parse_expression(sql: str) -> t.Expression:
    p = Parser(sql)
    expr = p.expression()
    if p.peek().type != TokenType.EOF:
        raise ParseError(f"unexpected trailing input at {p.peek().pos}")
    return expr
