"""SQL lexer.

Reference blueprint: the lexical rules of core/trino-grammar/.../SqlBase.g4 (the
IDENTIFIER / QUOTED_IDENTIFIER / STRING / number / comment rules at the bottom of
the grammar). Keywords are recognized case-insensitively; non-delimited identifiers
are lower-cased, as in Trino.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto
from typing import List


class TokenType(Enum):
    IDENT = auto()
    QUOTED_IDENT = auto()
    STRING = auto()
    INTEGER = auto()
    DECIMAL = auto()
    FLOAT = auto()
    OP = auto()          # punctuation / operators
    KEYWORD = auto()     # reserved & non-reserved words (uppercased in .value)
    PARAM = auto()       # ?
    EOF = auto()


KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT", "OFFSET",
    "AS", "AND", "OR", "NOT", "IN", "IS", "NULL", "TRUE", "FALSE", "BETWEEN", "LIKE",
    "ESCAPE", "CASE", "WHEN", "THEN", "ELSE", "END", "CAST", "TRY_CAST", "JOIN",
    "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON", "USING", "NATURAL",
    "UNION", "INTERSECT", "EXCEPT", "ALL", "DISTINCT", "ASC", "DESC", "NULLS",
    "FIRST", "LAST", "WITH", "VALUES", "TABLE", "EXISTS", "EXTRACT", "INTERVAL",
    "YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "DATE", "TIME", "TIMESTAMP",
    "CURRENT_DATE", "CURRENT_TIMESTAMP", "LOCALTIME", "LOCALTIMESTAMP", "EXPLAIN",
    "ANALYZE", "SHOW", "TABLES", "SCHEMAS", "COLUMNS", "CATALOGS", "SESSION", "SET", "RESET",
    "CREATE", "DROP", "INSERT", "INTO", "IF", "OVER", "PARTITION", "ROWS", "RANGE",
    "PRECEDING", "FOLLOWING", "UNBOUNDED", "CURRENT", "ROW", "FILTER", "GROUPING",
    "SETS", "ROLLUP", "CUBE", "UNNEST", "ORDINALITY", "LATERAL", "FETCH", "NEXT",
    "ONLY", "DESCRIBE", "SUBSTRING", "FOR", "POSITION",
    "DELETE", "UPDATE", "MERGE", "MATCHED", "WITHIN",
    "START", "TRANSACTION", "COMMIT", "ROLLBACK", "WORK", "READ", "ONLY",
    "WRITE", "ISOLATION", "LEVEL", "COMMITTED", "UNCOMMITTED", "REPEATABLE",
    "SERIALIZABLE", "PREPARE", "EXECUTE", "DEALLOCATE", "INPUT", "OUTPUT",
    "VIEW", "REPLACE", "IGNORE", "RESPECT",
    "MATCH_RECOGNIZE", "MEASURES", "PATTERN", "DEFINE", "AFTER", "SKIP",
    "PAST", "SUBSET", "MATCH", "PER", "ONE", "EMPTY", "OMIT", "TO", "MATCHES",
    "FUNCTION", "RETURNS", "RETURN", "DETERMINISTIC", "GRANT", "REVOKE",
    "PRIVILEGES", "OPTION", "ADMIN", "USER", "ROLE", "USE", "FUNCTIONS", "TYPE",
}

# Words that are keywords but can also be used as identifiers (Trino's
# nonReserved rule in SqlBase.g4). Kept permissive: anything not structurally
# required can fall back to identifier during parsing.
NON_RESERVED = {
    "YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND", "DATE", "TIME", "TIMESTAMP",
    "TABLES", "SCHEMAS", "COLUMNS", "CATALOGS", "SESSION", "ANALYZE", "SHOW", "SET", "RESET",
    "FIRST", "LAST", "ALL", "FILTER", "ROW", "ROWS", "RANGE", "ONLY", "NEXT",
    "ORDINALITY", "POSITION", "IF", "MATCHED", "WITHIN",
    "START", "TRANSACTION", "COMMIT", "ROLLBACK", "WORK", "READ", "ONLY",
    "WRITE", "ISOLATION", "LEVEL", "COMMITTED", "UNCOMMITTED", "REPEATABLE",
    "SERIALIZABLE", "INPUT", "OUTPUT", "VIEW", "REPLACE", "IGNORE", "RESPECT",
    "MEASURES", "PATTERN", "DEFINE", "AFTER", "SKIP", "PAST", "SUBSET",
    "MATCH", "PER", "ONE", "EMPTY", "OMIT", "TO", "MATCHES",
    "FUNCTION", "RETURNS", "RETURN", "DETERMINISTIC",
    "PRIVILEGES", "OPTION", "ADMIN", "USER", "ROLE", "FUNCTIONS", "TYPE",
}


@dataclass
class Token:
    type: TokenType
    value: str
    pos: int  # character offset, for error messages

    def __repr__(self):  # pragma: no cover
        return f"Token({self.type.name}, {self.value!r})"


class LexError(ValueError):
    pass


_OPERATORS = [
    "<>", "!=", "<=", ">=", "||", "->", "=>",
    "+", "-", "*", "/", "%", "=", "<", ">", "(", ")", ",", ".", ";", "?", "[", "]",
    "{", "}", "|",
]


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        # comments
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        # string literal (with '' escaping)
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated string literal at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token(TokenType.STRING, "".join(buf), i))
            i = j + 1
            continue
        # quoted identifier
        if c == '"':
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"unterminated quoted identifier at {i}")
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        buf.append('"')
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            # identifiers fold to lowercase, quoted or not (Trino resolves
            # identifiers case-insensitively; the canonical TPC-DS text
            # aliases "YEAR" and references "year")
            tokens.append(Token(TokenType.QUOTED_IDENT, "".join(buf).lower(), i))
            i = j + 1
            continue
        # number
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (
                    sql[j + 1].isdigit() or (sql[j + 1] in "+-" and j + 2 < n and sql[j + 2].isdigit())
                ):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            text = sql[i:j]
            if seen_exp:
                tokens.append(Token(TokenType.FLOAT, text, i))
            elif seen_dot:
                tokens.append(Token(TokenType.DECIMAL, text, i))
            else:
                tokens.append(Token(TokenType.INTEGER, text, i))
            i = j
            continue
        # identifier / keyword
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            upper = word.upper()
            if upper in KEYWORDS:
                tokens.append(Token(TokenType.KEYWORD, upper, i))
            else:
                tokens.append(Token(TokenType.IDENT, word.lower(), i))
            i = j
            continue
        # operators
        for op in _OPERATORS:
            if sql.startswith(op, i):
                tokens.append(Token(TokenType.OP, op, i))
                i += len(op)
                break
        else:
            raise LexError(f"unexpected character {c!r} at position {i}")
    tokens.append(Token(TokenType.EOF, "", n))
    return tokens
