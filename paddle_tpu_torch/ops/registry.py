"""Op registry over the port's copy of ops.yaml: counterpart of
paddle_tpu/ops/registry.py. The schema lists every op of the paddle API
(name, module, signature, whether it is a Tensor method, its AMP
category) and the dispatch-only AMP names (`amp_extra`); `amp.auto_cast`
reads its white and black lists from here.

The machine with the card has no PyYAML, so the file is read by
`_parse`, a reader of this schema's restricted shape: a top-level `ops:`
list of flat maps whose values are plain scalars (a value may continue on
lines indented past its key, joined with one space), then `amp_extra:`
with lists of names. The copy ships inside the package, so a file it
cannot read raises: there is no fallback list that could hide a
packaging fault.
"""
from __future__ import annotations

import functools
import os

__all__ = ["all_ops", "get", "search", "amp_white", "amp_black"]

PATH = os.path.join(os.path.dirname(__file__), "ops.yaml")


def _scalar(text):
    if text in ("true", "false"):
        return text == "true"
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def _parse(text):
    """The schema document as `yaml.safe_load` gives it."""
    doc, section, entry, key, sub, item = {}, None, None, None, None, 2
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.split(" #")[0].rstrip() if not raw.lstrip().startswith(
            "#") else ""
        if not line:
            continue
        indent = len(line) - len(line.lstrip())
        body = line.strip()
        if section == "ops" and body.startswith("- ") and indent in (0, 2):
            entry = {}
            doc["ops"].append(entry)
            item = indent + 2
            key = _set(entry, body[2:], n)
        elif indent == 0:
            if not body.endswith(":"):
                raise ValueError(f"ops.yaml:{n}: expected a section")
            section = body[:-1]
            doc[section] = [] if section == "ops" else {}
            entry = key = sub = None
        elif section == "ops" and entry is not None and indent == item:
            key = _set(entry, body, n)
        elif section == "ops" and key is not None and indent > item:
            entry[key] = f"{entry[key]} {body}"
        elif section == "amp_extra" and indent == 2 and body.endswith(":"):
            sub = body[:-1]
            doc[section][sub] = []
        elif section == "amp_extra" and body.startswith("- ") and sub:
            doc[section][sub].append(_scalar(body[2:].strip()))
        else:
            raise ValueError(f"ops.yaml:{n}: unexpected line {raw!r}")
    return doc


def _set(entry, body, n):
    key, sep, value = body.partition(":")
    if not sep:
        raise ValueError(f"ops.yaml:{n}: expected key: value")
    entry[key.strip()] = _scalar(value.strip())
    return key.strip()


@functools.lru_cache(maxsize=1)
def _load():
    with open(PATH) as f:
        return _parse(f.read())


@functools.lru_cache(maxsize=1)
def all_ops():
    """List of op entries: {op, module, signature, tensor_method, amp}."""
    return list(_load()["ops"])


@functools.lru_cache(maxsize=1)
def _by_name():
    return {e["op"]: e for e in all_ops()}


def get(name):
    return _by_name().get(name)


def search(pattern):
    """Substring search over op names: registry.search('conv')."""
    p = pattern.lower()
    return [e for e in all_ops() if p in e["op"].lower()]


def _amp(category):
    doc = _load()
    names = frozenset(e["op"] for e in doc.get("ops", [])
                      if e.get("amp") == category)
    extra = doc.get("amp_extra", {}) or {}
    return names | frozenset(extra.get(category, []) or [])


@functools.lru_cache(maxsize=1)
def amp_white():
    return _amp("white")


@functools.lru_cache(maxsize=1)
def amp_black():
    return _amp("black")
