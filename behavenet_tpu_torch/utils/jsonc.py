"""Comment-tolerant JSON loader (a copy of ``behavenet_tpu/utils/jsonc.py``).

The reference loads all four config files with commentjson
(reference: behavenet/fitting/hyperparam_utils.py:36-39); config files may
contain ``//`` line comments and ``/* */`` block comments.
"""

import json


def _strip_comments(text):
    """Remove // and /* */ comments from JSON text, respecting strings."""
    out = []
    i = 0
    n = len(text)
    in_string = False
    while i < n:
        c = text[i]
        if in_string:
            out.append(c)
            if c == '\\' and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_string = False
            i += 1
        else:
            if c == '"':
                in_string = True
                out.append(c)
                i += 1
            elif c == '/' and i + 1 < n and text[i + 1] == '/':
                while i < n and text[i] != '\n':
                    i += 1
            elif c == '/' and i + 1 < n and text[i + 1] == '*':
                i += 2
                while i + 1 < n and not (text[i] == '*' and text[i + 1] == '/'):
                    i += 1
                i += 2
            elif c == '#':
                # commentjson also supports python-style comments
                while i < n and text[i] != '\n':
                    i += 1
            else:
                out.append(c)
                i += 1
    return ''.join(out)


def loads(text):
    return json.loads(_strip_comments(text))


def load(fp):
    return loads(fp.read())


def load_file(path):
    with open(path, 'r') as f:
        return load(f)
