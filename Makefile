# Dev workflow (the reference's Makefile.toml analogue).

PY ?= python

.PHONY: test test-fast test-torch smoke fuzz bench microbench report native lint codehealth

native:
	$(PY) flacenc_tpu/native/build.py --force

test:
	$(PY) -m pytest tests/ -x -q

test-fast:
	$(PY) -m pytest tests/ -x -q --ignore=tests/test_device.py \
		--ignore=tests/test_experimental.py

# the PyTorch port's tests on the CPU (card-only tests skip)
test-torch:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/_native_guard tests/test_torch_*.py -q

# the port on one CUDA card: builds the kernels, drives every path
smoke:
	python3 chip_smoke.py

fuzz:
	$(PY) fuzz/run_fuzz.py --iters 200
	$(PY) fuzz/run_fuzz.py --mutate --iters 300
	$(PY) fuzz/run_fuzz.py --upload --iters 25
	$(PY) fuzz/run_fuzz.py --device --iters 25
	$(PY) fuzz/run_fuzz.py --device --strict --iters 15
	$(PY) fuzz/run_fuzz.py --cli --iters 15

bench:
	$(PY) bench.py

microbench:
	$(PY) tools/microbench.py

report:
	$(PY) tools/reporter.py -o report/report.md

lint:
	$(PY) -m compileall -q flacenc_tpu tools fuzz bench.py __graft_entry__.py \
		flacenc_tpu_torch chip_smoke.py

codehealth: lint test fuzz
