"""Reference-compatible ``.ini`` case configuration.

Parses the exact file format of the reference framework (see reference
``src/input.cxx``): ``[section]`` headers, ``item=value`` pairs, per-field
subitems ``item[sub]=value``, ``#`` comments, comma-separated lists.  Typed
getters mirror ``Input::get_item<T>``/``get_list<T>`` including default
handling, the "default" subitem fallback, and used-item tracking so unused
options can be reported at startup like the reference does
(``src/model.cxx:218``).
"""

import os


class IniError(Exception):
    pass


def _parse_bool(s):
    s = s.strip().lower()
    if s in ("1", "true"):
        return True
    if s in ("0", "false"):
        return False
    raise IniError("Illegal bool value: %r" % s)


_CASTS = {
    bool: _parse_bool,
    int: lambda s: int(s.strip()),
    float: lambda s: float(s.strip()),
    str: lambda s: s.strip(),
}


class Ini:
    """items[section][item][subitem] = value-string (subitem '' for plain)."""

    def __init__(self, path_or_text):
        self.items = {}
        self.used = set()
        if os.path.exists(path_or_text) or path_or_text.endswith(".ini"):
            with open(path_or_text) as f:
                text = f.read()
            self.path = path_or_text
        else:
            text = path_or_text
            self.path = "<string>"
        self._parse(text)

    def _parse(self, text):
        section = None
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].strip()
                self.items.setdefault(section, {})
                continue
            if "=" not in line:
                raise IniError("%s:%d: illegal line %r" % (self.path, lineno, raw))
            if section is None:
                raise IniError("%s:%d: item outside a section" % (self.path, lineno))
            key, value = line.split("=", 1)
            key = key.strip()
            subitem = ""
            if "[" in key and key.endswith("]"):
                key, subitem = key[:-1].split("[", 1)
                key, subitem = key.strip(), subitem.strip()
            self.items[section].setdefault(key, {})[subitem] = value.strip()

    def _lookup(self, section, item, subitem):
        sec = self.items.get(section)
        if sec is None or item not in sec:
            return None
        sub = sec[item]
        if subitem in sub:
            self.used.add((section, item, subitem))
            return sub[subitem]
        # Fall back to the "default" (plain) entry like the reference does for
        # per-field subscripted options.
        if "" in sub:
            self.used.add((section, item, ""))
            return sub[""]
        return None

    _NO_DEFAULT = object()

    def get_item(self, typ, section, item, subitem="", default=_NO_DEFAULT):
        raw = self._lookup(section, item, subitem)
        if raw is None:
            if default is Ini._NO_DEFAULT:
                name = "%s[%s]" % (item, subitem) if subitem else item
                raise IniError("No item [%s] %s in input" % (section, name))
            return default
        try:
            return _CASTS[typ](raw)
        except (ValueError, KeyError) as e:
            raise IniError("Illegal value for [%s] %s: %r (%s)"
                           % (section, item, raw, e))

    def get_list(self, typ, section, item, subitem="", default=_NO_DEFAULT):
        raw = self._lookup(section, item, subitem)
        if raw is None:
            if default is Ini._NO_DEFAULT:
                raise IniError("No list [%s] %s in input" % (section, item))
            return list(default)
        if raw == "":
            return []
        return [_CASTS[typ](v) for v in raw.split(",")]

    def has_item(self, section, item, subitem=""):
        return self._lookup(section, item, subitem) is not None

    def flag_as_used(self, section, item, subitem=""):
        self.used.add((section, item, subitem))

    def unused_items(self):
        out = []
        for section, items in self.items.items():
            for item, subs in items.items():
                for subitem in subs:
                    if (section, item, subitem) not in self.used:
                        out.append((section, item, subitem))
        return sorted(out)

    # Convenience wrappers used throughout the code base.
    def get_bool(self, *a, **k):
        return self.get_item(bool, *a, **k)

    def get_int(self, *a, **k):
        return self.get_item(int, *a, **k)

    def get_float(self, *a, **k):
        return self.get_item(float, *a, **k)

    def get_str(self, *a, **k):
        return self.get_item(str, *a, **k)
