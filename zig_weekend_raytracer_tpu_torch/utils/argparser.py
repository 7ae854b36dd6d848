"""Dataclass-reflective CLI argument parser (the port's own copy of
``utils/argparser.py``: the same parser, usage text and errors).

The reference derives its whole flag system from a plain struct via comptime
reflection (reference: src/argparser.zig:21-113): defining the struct *is*
the schema — defaults, required fields, optionals, enums (usage enumerates
variants), nested structs via a custom ``parse`` hook, and ``--help/-h`` as
an error sentinel (:124-126).  This module does the same with Python
dataclass reflection.

Usage:

    @dataclasses.dataclass
    class Args:
        image_width: int
        scene: SceneType = SceneType.EMISSIVE

    args = ArgParser(Args).parse(["--image_width=400"])
"""

from __future__ import annotations

import dataclasses
import enum
import io
import typing
from typing import Sequence, Type, TypeVar

T = TypeVar("T")


class ParseArgsError(Exception):
    """Base for all parse failures (reference: ParseArgsError,
    src/argparser.zig:7-18)."""


class HelpPassedInArgs(ParseArgsError):
    """--help/-h was passed; callers treat this as a clean exit sentinel."""


class UnknownArgument(ParseArgsError):
    pass


class MissingRequiredArgument(ParseArgsError):
    pass


class InvalidArgumentFormat(ParseArgsError):
    pass


class InvalidArgumentValue(ParseArgsError):
    pass


class MissingCustomParseFn(ParseArgsError):
    """A nested non-scalar field type must provide a ``parse(str)``
    classmethod (reference: src/argparser.zig nested-struct handling)."""


def _strip_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _parse_bool(text: str) -> bool:
    t = text.strip().lower()
    if t in ("true", "1", "yes", "on"):
        return True
    if t in ("false", "0", "no", "off"):
        return False
    raise InvalidArgumentValue(f"invalid bool value: {text!r}")


class ArgParser:
    def __init__(self, schema: Type[T], delimiter: str = "="):
        if not dataclasses.is_dataclass(schema):
            raise TypeError("ArgParser schema must be a dataclass")
        self.schema = schema
        self.delimiter = delimiter
        self.fields = {f.name: f for f in dataclasses.fields(schema)}
        # Resolve string annotations once (PEP 563 compatibility).
        self.hints = typing.get_type_hints(schema)

    def parse(self, argv: Sequence[str]) -> T:
        values: dict = {}
        for raw in argv:
            if raw in ("--help", "-h"):
                raise HelpPassedInArgs()
            if not raw.startswith("--"):
                raise InvalidArgumentFormat(
                    f"arguments must look like --key{self.delimiter}value: {raw!r}"
                )
            body = raw[2:]
            if self.delimiter not in body:
                raise InvalidArgumentFormat(
                    f"missing {self.delimiter!r} in {raw!r}"
                )
            key, text = body.split(self.delimiter, 1)
            field = self.fields.get(key)
            if field is None:
                raise UnknownArgument(f"unknown argument: --{key}")
            values[key] = self._convert(field, text)

        # defaults / required check
        kwargs: dict = {}
        for name, field in self.fields.items():
            if name in values:
                kwargs[name] = values[name]
            elif field.default is not dataclasses.MISSING:
                kwargs[name] = field.default
            elif field.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                kwargs[name] = field.default_factory()  # type: ignore[misc]
            else:
                tp, is_opt = _strip_optional(self.hints[name])
                if is_opt:
                    kwargs[name] = None
                else:
                    raise MissingRequiredArgument(
                        f"missing required argument: --{name}"
                    )
        return self.schema(**kwargs)

    def _convert(self, field: dataclasses.Field, text: str):
        tp, _ = _strip_optional(self.hints[field.name])
        if tp is bool:
            return _parse_bool(text)
        if tp is int:
            try:
                return int(text)
            except ValueError as e:
                raise InvalidArgumentValue(str(e)) from e
        if tp is float:
            try:
                return float(text)
            except ValueError as e:
                raise InvalidArgumentValue(str(e)) from e
        if tp is str:
            return text
        if isinstance(tp, type) and issubclass(tp, enum.Enum):
            # accept both the name and the value
            for member in tp:
                if text in (member.name, str(member.value), member.name.lower()):
                    return member
            allowed = ", ".join(m.name.lower() for m in tp)
            raise InvalidArgumentValue(
                f"invalid value {text!r} for --{field.name}; allowed: {allowed}"
            )
        parse_fn = getattr(tp, "parse", None)
        if callable(parse_fn):
            return parse_fn(text)
        raise MissingCustomParseFn(
            f"field {field.name!r} of type {tp!r} needs a parse() classmethod"
        )

    def usage(self) -> str:
        """Usage text enumerating every flag, defaults, and enum variants
        (reference: printUsage, src/argparser.zig:94-113)."""
        out = io.StringIO()
        out.write(f"Usage: --key{self.delimiter}value ...\n")
        for name, field in self.fields.items():
            tp, is_opt = _strip_optional(self.hints[name])
            tp_name = getattr(tp, "__name__", str(tp))
            line = f"  --{name}{self.delimiter}<{tp_name}>"
            if isinstance(tp, type) and issubclass(tp, enum.Enum):
                line += " one of {" + ", ".join(
                    m.name.lower() for m in tp
                ) + "}"
            if field.default is not dataclasses.MISSING:
                dflt = field.default
                if isinstance(dflt, enum.Enum):
                    dflt = dflt.name.lower()
                line += f" (default: {dflt})"
            elif is_opt:
                line += " (optional)"
            else:
                line += " (required)"
            out.write(line + "\n")
        out.write("  --help, -h\n")
        return out.getvalue()
