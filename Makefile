# Top-level targets — the role of the reference's Makefile (build modes,
# graphs; Makefile:1-87) for a Python/JAX framework.
PY ?= python

.PHONY: all native test test-all test-gpu bench sweep graphs multihost golden clean

all: native

native:
	$(MAKE) -C native

# Fast correctness gate on the CPU: everything except the slow tier
# (the fuzz sweeps).
test:
	$(PY) -m pytest tests/ -q -n 4 --dist loadgroup -m "not slow"

# Everything, including the fuzz sweeps (run after touching ops/*.py).
test-all:
	$(PY) -m pytest tests/ -q -n 4 --dist loadgroup

# The tests that need the card (the gpu marker), on a machine with one.
test-gpu:
	$(PY) -m pytest tests/ -q -m gpu

bench:
	$(PY) bench.py

sweep:
	$(PY) -m stereomatching.bench

graphs:
	$(PY) -m stereomatching.bench --graphs report

# Multi-process (multi-host emulation) correctness smoke.
multihost:
	python tools/multihost_smoke.py --procs 2 --local-devices 2

# Cross-repo golden diff against the compiled C reference (test/diff.sh).
golden:
	tools/diff_vs_reference.sh

clean:
	$(MAKE) -C native clean
	rm -rf report .pytest_cache
