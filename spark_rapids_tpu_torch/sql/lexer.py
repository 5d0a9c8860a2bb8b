"""SQL lexer: text -> token stream (copied from
spark_rapids_tpu/sql/lexer.py).

Keywords are not tokenized specially — the parser matches IDENT tokens
case-insensitively, which keeps the keyword set in one place (the
grammar) and lets non-reserved words double as identifiers.
"""

from __future__ import annotations

from typing import List, NamedTuple


class Token(NamedTuple):
    kind: str   # IDENT | NUMBER | STRING | OP | EOF
    value: str
    pos: int


class SqlLexError(ValueError):
    pass


_TWO_CHAR_OPS = ("<=", ">=", "<>", "!=", "||")
_ONE_CHAR_OPS = "+-*/%(),.<>=;"


def tokenize(text: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if text.startswith("--", i):            # line comment
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if text.startswith("/*", i):            # block comment
            j = text.find("*/", i + 2)
            if j < 0:
                raise SqlLexError(f"unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":                            # string literal, '' escape
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise SqlLexError(f"unterminated string at {i}")
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            out.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":                # quoted identifier
            end = text.find(c, i + 1)
            if end < 0:
                raise SqlLexError(f"unterminated quoted identifier at {i}")
            out.append(Token("IDENT", text[i + 1:end], i))
            i = end + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                ch = text[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j > i and \
                        j + 1 < n and (text[j + 1].isdigit()
                                       or text[j + 1] in "+-"):
                    seen_exp = True
                    j += 2 if text[j + 1] in "+-" else 1
                else:
                    break
            out.append(Token("NUMBER", text[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            out.append(Token("IDENT", text[i:j], i))
            i = j
            continue
        if text[i:i + 2] in _TWO_CHAR_OPS:
            out.append(Token("OP", text[i:i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            out.append(Token("OP", c, i))
            i += 1
            continue
        raise SqlLexError(f"unexpected character {c!r} at {i}")
    out.append(Token("EOF", "", n))
    return out
