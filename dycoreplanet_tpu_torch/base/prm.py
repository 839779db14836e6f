"""Minimal deal.II ParameterHandler-compatible ``.prm`` reader/writer.

The reference configures everything through deal.II text parameter files
(reference: source/model_data/boussinesq_model_parameters.cc:52-239).
To let a user of the reference switch frameworks without rewriting their
configs, this module parses the same grammar:

    # comment
    subsection Name
        set key = value          # trailing comments allowed
    end

Semantics matched to the reference's usage:
  * unknown entries are skipped (``parse_input(..., skip_undefined=true)``,
    reference: boussinesq_model_parameters.cc:43-46);
  * a missing file causes a template with defaults + docs to be written
    and a ``ParameterFileError`` raised
    (reference: boussinesq_model_parameters.cc:32-42).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union


class ParameterFileError(RuntimeError):
    pass


def _strip_comment(line: str) -> str:
    # deal.II comments start with '#'
    idx = line.find("#")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


def parse_prm(text: str) -> Dict[Tuple[str, ...], Dict[str, str]]:
    """Parse .prm text into {subsection-path-tuple: {key: raw value}}.

    ``end`` closes the innermost subsection. Multi-word keys (deal.II
    allows spaces in entry names) are preserved verbatim.
    """
    sections: Dict[Tuple[str, ...], Dict[str, str]] = {}
    stack: List[str] = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            stack.append(line[len("subsection"):].strip())
        elif low == "end":
            if not stack:
                raise ParameterFileError("unbalanced 'end' in parameter file")
            stack.pop()
        elif low.startswith("set "):
            body = line[4:]
            if "=" not in body:
                raise ParameterFileError(f"malformed 'set' line: {raw!r}")
            key, _, value = body.partition("=")
            sections.setdefault(tuple(stack), {})[key.strip()] = value.strip()
        else:
            raise ParameterFileError(f"unrecognized line in parameter file: {raw!r}")
    if stack:
        raise ParameterFileError(f"unclosed subsection(s): {stack}")
    return sections


@dataclass
class Entry:
    """A declared parameter: default, type tag, doc string."""

    default: str
    pattern: str  # 'double' | 'integer' | 'bool' | 'string'
    doc: str = ""


@dataclass
class PrmHandler:
    """Tiny functional equivalent of deal.II ParameterHandler.

    Declaration + typed getters + template generation, sufficient for the
    three config structs of the reference.
    """

    entries: Dict[Tuple[str, ...], Dict[str, Entry]] = field(default_factory=dict)
    values: Dict[Tuple[str, ...], Dict[str, str]] = field(default_factory=dict)

    def declare(self, path: Tuple[str, ...], name: str, default: str, pattern: str, doc: str = "") -> None:
        self.entries.setdefault(path, {})[name] = Entry(default, pattern, doc)

    def read(self, filename: Union[str, os.PathLike]) -> None:
        with open(filename) as f:
            self.read_text(f.read())

    def read_text(self, text: str) -> None:
        parsed = parse_prm(text)
        for path, kv in parsed.items():
            declared = self.entries.get(path, {})
            for key, value in kv.items():
                if key in declared:  # skip_undefined semantics
                    self.values.setdefault(path, {})[key] = value

    def _raw(self, path: Tuple[str, ...], name: str) -> str:
        declared = self.entries.get(path)
        if declared is None or name not in declared:
            raise KeyError(f"undeclared parameter {path}/{name}")
        return self.values.get(path, {}).get(name, declared[name].default)

    def get(self, path: Tuple[str, ...], name: str) -> str:
        return self._raw(path, name)

    def get_double(self, path: Tuple[str, ...], name: str) -> float:
        return float(self._raw(path, name))

    def get_integer(self, path: Tuple[str, ...], name: str) -> int:
        return int(self._raw(path, name))

    def get_bool(self, path: Tuple[str, ...], name: str) -> bool:
        v = self._raw(path, name).lower()
        if v in ("true", "yes", "1"):
            return True
        if v in ("false", "no", "0"):
            return False
        raise ParameterFileError(f"not a bool: {path}/{name} = {v!r}")

    def template_text(self) -> str:
        """Render all declared entries with defaults + docs as a .prm file
        (mirrors deal.II's print_parameters used by the reference when the
        config file is missing, boussinesq_model_parameters.cc:32-42)."""
        # group paths into a tree; simple approach: emit each top-level
        # subsection with nested ones in declaration order.
        lines: List[str] = []

        paths = list(self.entries.keys())

        def emit(prefix: Tuple[str, ...], depth: int) -> None:
            ind = "  " * depth
            own = self.entries.get(prefix, {})
            for name, e in own.items():
                if e.doc:
                    for doc_line in e.doc.splitlines():
                        lines.append(f"{ind}# {doc_line}")
                lines.append(f"{ind}set {name} = {e.default}")
            children = []
            for p in paths:
                if len(p) == len(prefix) + 1 and p[: len(prefix)] == prefix:
                    if p[-1] not in children:
                        children.append(p[-1])
            for child in children:
                lines.append(f"{ind}subsection {child}")
                emit(prefix + (child,), depth + 1)
                lines.append(f"{ind}end")

        # top-level sections
        tops: List[str] = []
        for p in paths:
            if len(p) >= 1 and p[0] not in tops:
                tops.append(p[0])
        for top in tops:
            lines.append(f"subsection {top}")
            emit((top,), 1)
            lines.append("end")
            lines.append("")
        return "\n".join(lines)

    def write_template(self, filename: Union[str, os.PathLike]) -> None:
        with open(filename, "w") as f:
            f.write(self.template_text())
