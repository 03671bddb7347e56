"""The port's check on the card, in one command:

    python3 chip_smoke.py [pytest arguments, e.g. -k vitb16]

1. The ``cuda``-marked tests of the port's card files (``CARD_FILES``), in
   this process: every hand-written kernel held against its plain version,
   and every main path run with the kernels' launch counts zeroed just
   before it (each such test records its counts as its ``launches``
   property). The JUnit report goes to ``build/chip_smoke/``.
2. ``team_tpu_torch.scripts.kernel_times``: each kernel timed alone, with
   its bound and its plain and library times (PERF.md §6).
3. One JSON line ``{"kernels": [...]}``: for each row of step 2, its
   times, bound, the largest |kernel − plain| on its inputs, and the
   launches that step 1's tests counted of its kernel; the same with the
   launches by test in ``build/chip_smoke/kernels.json``. Then
   ``{"ok": ..., "device": ...}``.

The limits are the tests'; this script states none. The exit code is
pytest's (1 as well if step 2 fails). It imports the port only, never jax.
"""

import json
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # gitignored
CARD_FILES = ("tests/test_torch_cuda.py", "tests/test_torch_siglip_cuda.py",
              "tests/test_torch_card_paths.py")


def run_card_tests(args) -> int:
    import pytest

    return int(pytest.main(["--noconftest", "-m", "cuda", "-q", "-p", "no:cacheprovider",
                            f"--junitxml={OUT / 'card_tests.xml'}", "-o", "junit_family=xunit1",
                            *(str(ROOT / f) for f in CARD_FILES), *args]))


def recorded_launches(report: Path) -> dict:
    """counter -> {test id: launches}, from the tests' ``launches``
    properties in the JUnit report."""
    by_counter = {}
    for case in ET.parse(report).iter("testcase"):
        for prop in case.iter("property"):
            if prop.get("name") != "launches":
                continue
            test = f"{case.get('classname')}::{case.get('name')}"
            for counter, n in json.loads(prop.get("value")).items():
                by_counter.setdefault(counter, {})[test] = n
    return by_counter


def kernels_line(rows: list, launches: dict) -> list:
    """Each timed row with the launches of its wrapper (the first word of its
    label; #29's variant by its own counter), and its causal and
    second-kernel launches where counted; then the counters no row times."""
    kernels, used = [], set()
    for row in rows:
        name = row["label"].split()[0].rstrip(",")
        variant = f"{name}{row['label'].split()[-1]}"
        counter = variant if variant in launches else name
        entry = dict(row)
        for key, tag in ((counter, ""), (f"{name}.causal", "causal_"), (f"{name}.proj", "proj_")):
            if key in launches:
                used.add(key)
                entry[f"{tag}launches"] = sum(launches[key].values())
                entry[f"{tag}launches_by_test"] = launches[key]
        kernels.append(entry)
    kernels += [{"label": key, "launches": sum(by_test.values()), "launches_by_test": by_test,
                 "timed": False} for key, by_test in sorted(launches.items()) if key not in used]
    return kernels


def main(args) -> int:
    import torch

    OUT.mkdir(parents=True, exist_ok=True)
    rc = run_card_tests(args)
    try:
        from team_tpu_torch.scripts import kernel_times

        rows = kernel_times.main()
    except Exception as e:  # noqa: BLE001 - step 1's verdict still stands and is printed
        print(f"chip_smoke: kernel_times failed: {e!r}", flush=True)
        rows, rc = [], rc or 1
    kernels = kernels_line(rows, recorded_launches(OUT / "card_tests.xml"))
    (OUT / "kernels.json").write_text(json.dumps({"kernels": kernels}, indent=1))
    print(json.dumps({"kernels": [{k: v for k, v in entry.items()
                                   if not k.endswith("_by_test") and k != "kernel_ms"}
                                  for entry in kernels]}))
    print(json.dumps({"ok": rc == 0, "card_tests_rc": rc,
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
