"""YAML experiment configs → attribute namespaces.

Copy of `encodec_tpu/train/config.py` (`ConfigNamespace`, `config_to_dict`,
`load_config`, `parse_segment`). `load_config` reads YAML with PyYAML where
it is importable and otherwise with `read_yaml`, a reader of the subset of
YAML the experiment configs (`encodec_tpu_torch/params/*.yaml`) and
PyYAML's `yaml.dump` snapshots use, which gives `yaml.safe_load`'s dict,
types included; a `.json` config is read as JSON.

The subset: block maps, block lists of scalars, flow lists of scalars on
one line, comments, plain and quoted scalars (no backslash escapes). Plain
scalars resolve by PyYAML's YAML 1.1 rules: `3.` is a float but `1e-3` is
the string '1e-3' (no dot), `yes`/`on` are True, `~` and an empty value
are None. Anything else (anchors, aliases, tags, block scalars, several
documents, directives, multi-line scalars and flow lists, flow maps,
nested collections, timestamps, binary, octal, hex and sexagesimal
numbers, `.inf` and `.nan`, tabs) raises a ValueError naming the file and
line: it is never read as something else.
"""

from __future__ import annotations

import json
import os
import re
import typing as tp


class ConfigNamespace:
    """Recursive dict → attribute access."""

    def __init__(self, dictionary: tp.Dict[str, tp.Any]):
        for key, value in dictionary.items():
            if isinstance(value, dict):
                value = ConfigNamespace(value)
            setattr(self, key, value)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __repr__(self):
        return f"ConfigNamespace({self.__dict__})"


def config_to_dict(cfg) -> dict:
    if isinstance(cfg, ConfigNamespace):
        return {k: config_to_dict(v) for k, v in cfg.__dict__.items()}
    return cfg


def load_config(filepath: str, log_dir: tp.Optional[str] = None) -> ConfigNamespace:
    """Load a YAML config (or JSON, by the `.json` suffix); optionally
    snapshot it into `log_dir` for resume (`write_snapshot`; JSON when it
    was JSON)."""
    yaml = _pyyaml()
    with open(filepath, "r") as fh:
        if filepath.endswith(".json"):
            config_dict = json.load(fh)
        elif yaml is not None:
            config_dict = yaml.safe_load(fh)
        else:
            config_dict = read_yaml(fh.read(), filepath)
    if log_dir:
        write_snapshot(config_dict, log_dir,
                       as_yaml=not filepath.endswith(".json"))
    return ConfigNamespace(config_dict)


def write_snapshot(config_dict: dict, log_dir: str,
                   as_yaml: bool = True) -> None:
    """The experiment config in the run directory, for a self-contained
    resume (ref train.py:379-384): `config.yaml` when `as_yaml` and PyYAML
    is importable, else `config.json`."""
    os.makedirs(log_dir, exist_ok=True)
    yaml = _pyyaml() if as_yaml else None
    name = "config.json" if yaml is None else "config.yaml"
    with open(os.path.join(log_dir, name), "w") as fh:
        if yaml is None:
            json.dump(config_dict, fh)
        else:
            yaml.dump(config_dict, fh)


def _pyyaml():
    try:
        import yaml
    except ImportError:
        return None
    return yaml


def parse_segment(value) -> tp.Optional[float]:
    """The reference stores segment as the *string* 'None' and eval()s it;
    parse it safely instead."""
    if value is None or value == "None":
        return None
    return float(value)


# -- the YAML subset reader -------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
# characters a plain scalar may not start with (yaml/scanner.py
# check_plain), beyond the flow and quote openers handled on their own
_REFUSED_FIRST = {"&": "an anchor", "*": "an alias", "!": "a tag",
                  "|": "a block scalar", ">": "a block scalar",
                  "%": "a directive", "@": "a reserved indicator",
                  "`": "a reserved indicator"}


class _Refused(Exception):
    """YAML outside the subset, or malformed; `where` is the 1-based line."""

    def __init__(self, what: str, where: int = 0):
        super().__init__(what)
        self.what, self.where = what, where


def _resolve(text: str) -> tp.Any:
    """A plain scalar as PyYAML's SafeLoader resolves and constructs it."""
    if _BOOL.match(text):
        return _BOOLS[text.lower()]
    if _NULL.match(text):
        return None
    if text[:1] in "-+0123456789." and _FLOAT.match(text):
        if ":" in text:
            raise _Refused(f"the sexagesimal float {text!r}")
        if text.lstrip("+-")[:2] in (".i", ".I", ".n", ".N"):
            raise _Refused(f"the float {text!r}")
        return float(text.replace("_", ""))
    if text[:1] in "-+0123456789" and _INT.match(text):
        digits = text.lstrip("+-")
        if ":" in text:
            raise _Refused(f"the sexagesimal int {text!r}")
        if digits[:2] in ("0b", "0x"):
            raise _Refused(f"the {'binary' if digits[1] == 'b' else 'hex'} "
                           f"int {text!r}")
        if digits[:1] == "0" and digits != "0":
            raise _Refused(f"the octal int {text!r}")
        return int(text.replace("_", ""))
    if _TIMESTAMP.match(text):
        raise _Refused(f"the timestamp {text!r}")
    if text == "<<":
        raise _Refused("a merge key")
    if text == "=":
        raise _Refused("a value key '='")
    return text


def _quoted(s: str, i: int) -> tp.Tuple[str, int]:
    """The quoted scalar starting at s[i] and the index after it."""
    quote, out, j = s[i], [], i + 1
    while j < len(s):
        ch = s[j]
        if ch == quote:
            if quote == "'" and s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and ch == "\\":
            raise _Refused("a backslash escape")
        out.append(ch)
        j += 1
    raise _Refused("a quoted scalar spanning lines")


def _plain_start(s: str, i: int, flow: bool) -> None:
    """Refuse what may not begin a plain scalar in the subset."""
    ch, nxt = s[i], s[i + 1:i + 2]
    if ch in _REFUSED_FIRST:
        raise _Refused(_REFUSED_FIRST[ch])
    if ch in ",]}" or (ch in "-?:" and nxt in ("", " ")) or (
            flow and ch in "-?:" and nxt in ",]"):
        raise _Refused(f"a scalar starting with {ch!r}")


def _end_of_line(s: str, j: int) -> None:
    """Only blanks or a comment may follow a complete value."""
    rest = s[j:]
    if rest.strip() and not rest.lstrip().startswith("#"):
        raise _Refused(f"text after a value: {rest.strip()!r}")
    if rest.strip() and not rest[:1].isspace():
        raise _Refused("a comment not preceded by a blank")


def _flow_list(s: str, i: int) -> tp.Tuple[list, int]:
    """The flow list of scalars opening at s[i], closed on the same line:
    (its values, the index after it)."""
    out, j = [], i + 1
    while True:
        while s[j:j + 1] == " ":
            j += 1
        if j >= len(s):
            raise _Refused("a flow list spanning lines")
        if s[j] == "]":                  # empty, or after a trailing comma
            return out, j + 1
        if s[j] in "[{":
            raise _Refused("a collection in a flow list")
        if s[j] in "'\"":
            value, j = _quoted(s, j)
        else:
            _plain_start(s, j, flow=True)
            k = j
            while k < len(s) and s[k] not in ",[]{}":
                if s[k] == "#" and s[k - 1] == " ":
                    raise _Refused("a flow list spanning lines")
                if s[k] in "?:":
                    raise _Refused(f"{s[k]!r} in a flow scalar")
                k += 1
            value, j = _resolve(s[j:k].rstrip()), k
        out.append(value)
        while s[j:j + 1] == " ":
            j += 1
        if s[j:j + 1] == "]":
            return out, j + 1
        if s[j:j + 1] != ",":
            raise _Refused("a flow list spanning lines" if j >= len(s)
                           else f"{s[j]!r} in a flow list")
        j += 1


def _block_value(s: str) -> tp.Any:
    """The value after `key: ` or `- ` on one line (`s` stripped on the
    left, not empty)."""
    if s[0] == "{":
        raise _Refused("a flow map")
    if s[0] == "[":
        value, j = _flow_list(s, 0)
        _end_of_line(s, j)
        return value
    if s[0] in "'\"":
        value, j = _quoted(s, 0)
        _end_of_line(s, j)
        return value
    _plain_start(s, 0, flow=False)
    cut = re.search(r"\s#", s)
    text = (s[:cut.start()] if cut else s).rstrip()
    if re.search(r":(\s|$)", text):
        raise _Refused("a map inside a scalar or a list item")
    return _resolve(text)


def _split_key(s: str) -> tp.Optional[tp.Tuple[tp.Any, str]]:
    """(key, the rest after ':') of a block map line, or None."""
    if s[0] in "'\"":
        key, j = _quoted(s, 0)
        rest = s[j:].lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:]
    if s[0] in "[{":
        raise _Refused("a collection as a key")
    if s[0] == "?" and s[1:2] in ("", " "):
        raise _Refused("a complex key ('? ')")
    m = re.search(r":( |$)", s)
    if m is None:
        return None
    text = s[:m.start()].rstrip()
    if re.search(r"\s#", text):
        return None
    if not text:
        raise _Refused("an empty key")
    _plain_start(text, 0, flow=False)
    return _resolve(text), s[m.end():]


def _lines(text: str) -> tp.List[tp.Tuple[int, int, str]]:
    """(line number, indent, content) of the lines holding content."""
    out = []
    seen_content = False
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip("\r").rstrip(" ")
        if "\t" in line:
            raise _Refused("a tab", n)
        content = line.lstrip(" ")
        if not content or content.startswith("#"):
            continue
        indent = len(line) - len(content)
        if indent == 0 and (content == "---" or content.startswith("--- ")
                            or content == "..." or content.startswith("... ")):
            if content == "---" and not seen_content:
                seen_content = True      # the first document's explicit start
                continue
            raise _Refused("a document marker (several documents)", n)
        if indent == 0 and content.startswith("%"):
            raise _Refused("a directive", n)
        seen_content = True
        out.append((n, indent, content))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Block:
    """Recursive descent over the content lines."""

    def __init__(self, lines):
        self.lines, self.i = lines, 0

    def node(self, indent: int) -> tp.Any:
        if _is_item(self.lines[self.i][2]):
            return self.seq(indent)
        return self.map(indent)

    def _child(self, indent: int, same_indent_list: bool) -> tp.Any:
        """The block under a key (or None when nothing is nested)."""
        if self.i < len(self.lines):
            n, ind, content = self.lines[self.i]
            if ind > indent:
                return self.node(ind)
            if same_indent_list and ind == indent and _is_item(content):
                return self.seq(indent)
        return None

    def map(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            n, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise _Refused("a line indented past its map (a multi-line "
                               "scalar?)", n)
            if _is_item(content):
                raise _Refused("a list item where a map key was expected", n)
            try:
                split = _split_key(content)
            except _Refused as exc:
                raise _Refused(exc.what, n) from None
            if split is None:
                raise _Refused("a line that is not 'key: value'", n)
            key, rest = split
            self.i += 1
            rest = rest.strip(" ")
            if not rest or rest.startswith("#"):
                value = self._child(indent, same_indent_list=True)
            else:
                try:
                    value = _block_value(rest)
                except _Refused as exc:
                    raise _Refused(exc.what, n) from None
                if self.i < len(self.lines) and \
                        self.lines[self.i][1] > indent:
                    raise _Refused("a line indented under a scalar value "
                                   "(a multi-line scalar?)",
                                   self.lines[self.i][0])
            if isinstance(key, (list, dict)):
                raise _Refused("a collection as a key", n)
            out[key] = value
        return out

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            n, ind, content = self.lines[self.i]
            if ind != indent or not _is_item(content):
                if ind > indent:
                    raise _Refused("a line indented past its list item", n)
                break
            self.i += 1
            rest = content[1:].strip(" ")
            if not rest or rest.startswith("#"):
                if self.i < len(self.lines) and \
                        self.lines[self.i][1] > indent:
                    raise _Refused("a block nested in a list item", n)
                out.append(None)
                continue
            if _is_item(rest):
                raise _Refused("a list nested in a list item", n)
            try:
                out.append(_block_value(rest))
            except _Refused as exc:
                raise _Refused(exc.what, n) from None
        return out


def read_yaml(text: str, path: str = "<string>") -> tp.Any:
    """`yaml.safe_load(text)` for the subset of YAML described in the module
    docstring; a ValueError naming `path` and the line for anything else."""
    try:
        lines = _lines(text)
        if not lines:
            return None
        block = _Block(lines)
        value = block.node(lines[0][1])
        if block.i < len(lines):
            raise _Refused("a line outdented past the document's first",
                           lines[block.i][0])
        return value
    except _Refused as exc:
        where = f"{path}:{exc.where}" if exc.where else path
        raise ValueError(f"{where}: {exc.what} is outside the YAML subset "
                         "read without PyYAML") from None
