"""Minimal yacs-compatible configuration node (a copy of
``halo_tpu/config/node.py``; the port keeps its own).

The reference framework configures everything through a yacs ``CfgNode``
singleton (reference: core/configs/defaults.py:5-99, core/utils/misc.py:137-162).
yacs is not available in this environment, so this module provides a small,
dependency-free re-implementation of the API surface the framework uses:

  * attribute-style access (``cfg.MODEL.NAME``)
  * ``merge_from_file`` (YAML)
  * ``merge_from_list`` ([KEY, VALUE, KEY, VALUE, ...] CLI overrides)
  * ``set_new_allowed`` / ``freeze`` / ``defrost`` / ``clone``
  * literal-eval of override strings, including tuples like ``(1280, 720)``

Behavioral parity notes: like yacs, merging a value whose type differs from
the default is allowed for int<->float and list<->tuple coercions, and new
keys are only accepted after ``set_new_allowed(True)`` (the reference calls
this before merging, so recipe YAMLs may introduce extra keys such as
``ACTIVE.RATIO``).
"""

from __future__ import annotations

import ast
import copy
import io


_FROZEN = "__frozen__"
_NEW_ALLOWED = "__new_allowed__"


class CfgNode(dict):
    """A dict subclass with attribute access and yacs-style merging."""

    def __init__(self, init_dict=None, new_allowed=False):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        self.__dict__[_FROZEN] = False
        self.__dict__[_NEW_ALLOWED] = new_allowed
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v, new_allowed=new_allowed)
            dict.__setitem__(self, k, v)

    # -- attribute access ------------------------------------------------
    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(
            "Non-existent config key: {}".format(name))

    def __setattr__(self, name, value):
        if self.__dict__.get(_FROZEN, False):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    name, value))
        self[name] = value

    def __setitem__(self, name, value):
        if self.__dict__.get(_FROZEN, False):
            raise AttributeError(
                "Attempted to set {} to {}, but CfgNode is immutable".format(
                    name, value))
        dict.__setitem__(self, name, value)

    # -- freezing --------------------------------------------------------
    def freeze(self):
        self._set_frozen(True)

    def defrost(self):
        self._set_frozen(False)

    def is_frozen(self):
        return self.__dict__[_FROZEN]

    def _set_frozen(self, frozen):
        self.__dict__[_FROZEN] = frozen
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_frozen(frozen)

    def set_new_allowed(self, new_allowed):
        self.__dict__[_NEW_ALLOWED] = new_allowed
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(new_allowed)

    def is_new_allowed(self):
        return self.__dict__[_NEW_ALLOWED]

    def clone(self):
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        out.__dict__[_FROZEN] = False
        out.__dict__[_NEW_ALLOWED] = self.__dict__[_NEW_ALLOWED]
        for k, v in self.items():
            dict.__setitem__(out, k, copy.deepcopy(v, memo))
        out.__dict__[_FROZEN] = self.__dict__[_FROZEN]
        return out

    # -- merging ---------------------------------------------------------
    def merge_from_file(self, cfg_filename):
        with open(cfg_filename, "r") as f:
            loaded = _load_yaml(f.read())
        self._merge_dict(loaded if loaded else {}, [])

    def merge_from_other_cfg(self, other):
        self._merge_dict(other, [])

    def merge_from_list(self, cfg_list):
        if cfg_list is None:
            return
        assert len(cfg_list) % 2 == 0, (
            "Override list has odd length: {}".format(cfg_list))
        for key, value in zip(cfg_list[0::2], cfg_list[1::2]):
            parts = key.split(".")
            node = self
            for p in parts[:-1]:
                if not isinstance(node, CfgNode) or p not in node:
                    raise KeyError("Non-existent key: {}".format(key))
                node = node[p]
            leaf = parts[-1]
            if not isinstance(node, CfgNode):
                raise KeyError("Non-existent key: {}".format(key))
            # yacs asserts CLI-override keys exist REGARDLESS of
            # set_new_allowed (yacs merge_from_list vs merge_from_file):
            # a typo'd 'SOLVER.BATCH_SZIE 8' must error, not silently
            # create a dead key while a long run trains on the default.
            if leaf not in node:
                raise KeyError("Non-existent key: {}".format(key))
            value = _decode_value(value)
            value = _coerce(value, node[leaf], key)
            dict.__setitem__(node, leaf, value)

    def _merge_dict(self, other, key_path):
        for k, v in other.items():
            full = ".".join(key_path + [str(k)])
            if k in self:
                cur = self[k]
                if isinstance(cur, CfgNode):
                    if not isinstance(v, dict):
                        raise TypeError(
                            "Cannot merge non-dict into config section {}".format(full))
                    cur._merge_dict(v, key_path + [str(k)])
                else:
                    v = _decode_value(v)
                    v = _coerce(v, cur, full)
                    dict.__setitem__(self, k, v)
            else:
                if not self.is_new_allowed():
                    raise KeyError("Non-existent config key: {}".format(full))
                if isinstance(v, dict):
                    node = CfgNode(v, new_allowed=True)
                    dict.__setitem__(self, k, node)
                else:
                    dict.__setitem__(self, k, _decode_value(v))

    # -- repr ------------------------------------------------------------
    def dump(self):
        return _dump_yaml(self)

    def __str__(self):
        def _indent(s, n):
            pad = " " * n
            return "\n".join(pad + line for line in s.split("\n"))

        lines = []
        for k in sorted(self.keys()):
            v = self[k]
            if isinstance(v, CfgNode):
                lines.append("{}:".format(k))
                lines.append(_indent(str(v), 2))
            else:
                lines.append("{}: {}".format(k, v))
        return "\n".join(lines)

    def __repr__(self):
        return "{}({})".format(self.__class__.__name__, super().__repr__())


def _decode_value(value):
    """Literal-eval strings like yacs does ('(1280, 720)' -> tuple)."""
    if not isinstance(value, str):
        return value
    try:
        v = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
    if isinstance(v, (int, float, bool, list, tuple, dict, type(None), str)):
        return v
    return value


def _coerce(new, old, key):
    """yacs-style replacement type checking with a few sanctioned casts."""
    if old is None or new is None:
        return new
    if type(new) is type(old):
        return new
    casts = [(tuple, list), (list, tuple), (int, float), (float, int),
             (str, type(old))]
    for src, dst in casts:
        if isinstance(new, src) and isinstance(old, dst):
            try:
                return dst(new) if dst in (tuple, list, float, int) else new
            except (TypeError, ValueError):
                break
    if isinstance(old, bool) and isinstance(new, int):
        return bool(new)
    raise ValueError(
        "Type mismatch ({} vs {}) for config key {}: {} vs {}".format(
            type(old), type(new), key, old, new))


# --------------------------------------------------------------------------
# Tiny YAML subset reader/writer: supports the mapping/list/scalar structures
# used by the recipe files (nested maps, inline lists, tuples-as-strings,
# comments). Falls back to PyYAML when available for full coverage.
# --------------------------------------------------------------------------

def _load_yaml(text):
    try:
        import yaml  # noqa
        return yaml.safe_load(text)
    except ImportError:
        pass
    return _MiniYaml(text).parse()


def _dump_yaml(node, indent=0):
    out = io.StringIO()
    pad = " " * indent
    for k in sorted(node.keys()):
        v = node[k]
        if isinstance(v, CfgNode):
            out.write("{}{}:\n".format(pad, k))
            out.write(_dump_yaml(v, indent + 2))
        else:
            out.write("{}{}: {!r}\n".format(pad, k, v))
    return out.getvalue()


class _MiniYaml:
    """A small indentation-based YAML mapping parser (scalars, inline lists)."""

    def __init__(self, text):
        self.lines = []
        for raw in text.split("\n"):
            stripped = self._strip_comment(raw).rstrip()
            if stripped.strip():
                indent = len(stripped) - len(stripped.lstrip())
                self.lines.append((indent, stripped.strip()))
        self.pos = 0

    @staticmethod
    def _strip_comment(line):
        out = []
        in_s = in_d = False
        for ch in line:
            if ch == "'" and not in_d:
                in_s = not in_s
            elif ch == '"' and not in_s:
                in_d = not in_d
            elif ch == "#" and not in_s and not in_d:
                break
            out.append(ch)
        return "".join(out)

    def parse(self):
        return self._parse_block(0)

    def _parse_block(self, indent):
        result = {}
        while self.pos < len(self.lines):
            line_indent, content = self.lines[self.pos]
            if line_indent < indent:
                break
            if line_indent > indent:
                raise ValueError("Bad YAML indentation: {}".format(content))
            if ":" not in content:
                raise ValueError("Expected 'key: value', got: {}".format(content))
            key, _, rest = content.partition(":")
            key = key.strip()
            rest = rest.strip()
            self.pos += 1
            if rest == "":
                if (self.pos < len(self.lines)
                        and self.lines[self.pos][0] > indent):
                    result[key] = self._parse_block(self.lines[self.pos][0])
                else:
                    result[key] = None
            else:
                result[key] = self._parse_scalar(rest)
        return result

    @staticmethod
    def _parse_scalar(s):
        low = s.lower()
        if low in ("true", "yes"):
            return True
        if low in ("false", "no"):
            return False
        if low in ("null", "~", "none"):
            return None
        if (s.startswith("'") and s.endswith("'")) or (
                s.startswith('"') and s.endswith('"')):
            return s[1:-1]
        try:
            v = ast.literal_eval(s)
            if isinstance(v, (int, float, bool, list, tuple, dict)):
                return v
        except (ValueError, SyntaxError):
            pass
        return s
