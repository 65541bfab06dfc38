"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one driver
or one metric is a file of its own, found by the name the manifest (or a
traffic file) gives it:

- a configuration: the ``file`` of its entry (``benchmark/configs/``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, the parameters of the
  driver its ``"driver"`` key names;
- a driver: ``benchmark/drivers/<driver>.py``, whose ``Driver`` class runs
  the program (``benchmark.entry.Driver``), and its control
  ``benchmark/controls/<driver>.py``, whose ``readings(config, traffic,
  seed, max_iters)`` judges the reference in bfloat16 in the program's place;
- a metric: ``benchmark/metrics/<name>.py``, whose ``read(run)`` returns the
  metric's value or None when the run gave it nothing to read. A metric
  ``<quantity>.<variant>`` without a file of its own is read by
  ``benchmark/metrics/<quantity>.py``: the variants of one quantity, which
  report in cells of different end-to-end metrics, share one reader.

So a cell, a configuration, a driver or a metric is added with new files
and new entries in ``BENCHMARK.json``, and no file that exists changes.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def merge(base, over):
    """``base`` with the values of ``over`` put in, nested dicts merged."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class Manifest:
    """The manifest at ``root`` (the checkout's root by default)."""

    def __init__(self, root=ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.doc = json.load(fh)
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.workloads = {w["name"]: w for w in self.doc["workloads"]}

    def workload(self, name):
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.workloads[name]

    def cell(self, workload, overrides=None):
        """(workload entry, configuration, traffic) of ``workload``, with
        ``overrides`` ({"config": ..., "traffic": ...}) merged in."""
        wl = self.workload(workload)
        overrides = overrides or {}
        return (wl, merge(self.config(wl["config"]), overrides.get("config")),
                merge(self.traffic(wl["traffic"]), overrides.get("traffic")))

    def config(self, name):
        with open(os.path.join(self.root, self.configs[name]["file"])) as fh:
            return json.load(fh)

    def traffic(self, name):
        with open(os.path.join(self.root, "benchmark", "traffic", f"{name}.json")) as fh:
            return json.load(fh)

    def metrics(self, workload, traced):
        """The metric entries a run of ``workload`` reports: with ``traced``
        the per-layer ones, else the end-to-end ones; each where its
        ``workloads`` lists the cell or it has no such key."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.doc[kind] if workload in m.get("workloads", [workload])]

    def _load(self, kind, name, prefix):
        path = os.path.join(self.root, "benchmark", kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(prefix + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def driver(self, name):
        """The ``Driver`` class of driver ``name``."""
        return self._load("drivers", name, "benchmark_driver_").Driver

    def control(self, name):
        """The control module of driver ``name``."""
        return self._load("controls", name, "benchmark_control_")

    def reader_file(self, metric):
        """The reader's name of ``metric``: its own, else its quantity's."""
        return metric if self._exists("metrics", metric) else metric.partition(".")[0]

    def reader(self, metric):
        """The ``read`` function of ``metric``'s reader."""
        return self._load("metrics", self.reader_file(metric), "benchmark_metric_").read

    def _exists(self, kind, name):
        return os.path.exists(os.path.join(self.root, "benchmark", kind, f"{name}.py"))

    def problems(self):
        """What breaks the manifest's character and reference rules (empty
        when none)."""
        out = []
        doc = self.doc
        names = ([c["name"] for c in doc["configs"]] + [w["name"] for w in doc["workloads"]]
                 + [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
                 + [w[k] for w in doc["workloads"] for k in ("config", "traffic")]
                 + [k for c in doc["configs"] for k in c["reduced"]])
        out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
        out += [f"bad unit {m['unit']!r}" for m in doc["end_to_end"] + doc["per_layer"]
                if not UNIT.match(m["unit"])]
        for w in doc["workloads"]:
            if w["config"] not in self.configs:
                out.append(f"{w['name']}: unknown config {w['config']!r}")
            try:
                driver = self.traffic(w["traffic"])["driver"]
            except (OSError, ValueError, KeyError):
                out.append(f"{w['name']}: no traffic file naming a driver for {w['traffic']!r}")
                continue
            for kind in ("drivers", "controls"):
                if not self._exists(kind, driver):
                    out.append(f"{w['name']}: no {kind}/{driver}.py")
        for m in doc["end_to_end"] + doc["per_layer"]:
            if not self._exists("metrics", self.reader_file(m["name"])):
                out.append(f"no reader for metric {m['name']!r}")
        return out
