"""SQL string frontend: ``session.sql("SELECT ...")``.

Counterpart of spark_rapids_tpu/sql: the same lexer and recursive-descent
parser, and the analyzer that lowers the AST onto this port's DataFrame /
logical-plan layer. A function, clause or join type the port does not
have yet raises ``SqlError`` (``NotImplementedError`` for a join type the
planner lacks); it never takes another path.
"""

from .parser import SqlError, parse_sql  # noqa: F401
