"""YAML/CLI configuration front end (counterpart of ``mlmc_tpu/tool/config.py``).

The reference passes plain dicts through LevelSimulation and reads YAML
ad-hoc (ruamel.yaml in synth_simulation.py:291-296, pbs_job.py:126-130).
Here a small, typed front end:

* ``load_config(path, overrides)`` — YAML -> dict with ``include:`` merge
  (included files are deep-merged, later keys win) and ``a.b.c=value``
  dotted overrides (CLI friendly),
* ``validate_config(config, schema)`` — structural check against a schema
  dict mapping keys to types / nested schemas / callables,
* configs stay plain dicts/lists/scalars, so they pass directly into
  LevelSimulation.config_dict.

``yaml`` is imported by the functions that parse, so the module imports
where it is not installed.
"""
import copy
import os


def deep_merge(base, override):
    """Recursive dict merge; override wins on conflicts."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _parse_scalar(text):
    """YAML-style scalar parsing for override values."""
    import yaml

    return yaml.safe_load(text)


def apply_overrides(config, overrides):
    """Apply ``a.b.c=value`` dotted-path overrides (CLI style)."""
    config = copy.deepcopy(config)
    for item in overrides or []:
        path, _, raw = item.partition("=")
        if not _:
            raise ValueError("override must be key.path=value: {}".format(item))
        keys = path.strip().split(".")
        node = config
        for k in keys[:-1]:
            node = node.setdefault(k, {})
            if not isinstance(node, dict):
                raise ValueError(
                    "override path {} crosses a non-dict".format(path))
        node[keys[-1]] = _parse_scalar(raw)
    return config


def load_config(path, overrides=None, _seen=None):
    """Load a YAML config with ``include:`` merging + dotted overrides.

    ``include`` may be a path or list of paths relative to the config file;
    included configs are merged first (in order), the including file wins.
    Include cycles are detected and reported by file name.
    """
    path = os.path.abspath(path)
    seen = set() if _seen is None else _seen
    if path in seen:
        raise ValueError(
            "config include cycle involving {!r}".format(path))
    seen.add(path)
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    includes = raw.pop("include", [])
    if isinstance(includes, str):
        includes = [includes]
    merged = {}
    for inc in includes:
        inc_path = inc if os.path.isabs(inc) else \
            os.path.join(os.path.dirname(path), inc)
        merged = deep_merge(merged, load_config(inc_path, _seen=seen))
    merged = deep_merge(merged, raw)
    return apply_overrides(merged, overrides)


def validate_config(config, schema, path="config"):
    """Structural validation: schema values are types, nested dicts, or
    callables (predicate raising/returning False on invalid). Keys absent
    from the schema pass through; schema keys ending in '?' are optional.
    """
    errors = []
    for key, spec in schema.items():
        optional = key.endswith("?")
        k = key[:-1] if optional else key
        if k not in config:
            if not optional:
                errors.append("{}.{} missing".format(path, k))
            continue
        value = config[k]
        if isinstance(spec, dict):
            if not isinstance(value, dict):
                errors.append("{}.{} must be a mapping".format(path, k))
            else:
                errors.extend(validate_config(value, spec,
                                              "{}.{}".format(path, k)))
        elif isinstance(spec, type) or isinstance(spec, tuple):
            if not isinstance(value, spec):
                errors.append("{}.{} must be {}, got {}".format(
                    path, k, spec, type(value).__name__))
        elif callable(spec):
            try:
                ok = spec(value)
            except Exception as e:
                ok = False
                errors.append("{}.{}: {}".format(path, k, e))
            else:
                # None = procedural predicate (asserts itself); any other
                # falsy result (incl. numpy False_) is a failure
                if ok is not None and not ok:
                    errors.append("{}.{} failed validation".format(path, k))
    if path == "config" and errors:
        raise ValueError("invalid config:\n  " + "\n  ".join(errors))
    return errors
