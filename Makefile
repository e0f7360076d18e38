# distributions_tpu build/test targets (reference Makefile analog)

PYTHON ?= python

all: ext test

ext:
	$(PYTHON) setup.py build_ext --inplace

proto:
	protoc --python_out=. distributions_tpu/io/schema.proto

test:
	$(PYTHON) -m pytest tests/ -q

test-fast:
	$(PYTHON) -m pytest tests/ -q -x -k "not gof and not joint and not sweep"

bench:
	$(PYTHON) bench.py

bench-suite:
	$(PYTHON) benchmarks/suite.py

demo:
	PYTHONPATH=. $(PYTHON) examples/mixture/main.py run --samples 2000 --passes 5

derivations:
	$(PYTHON) derivations/betabinomial.py
	$(PYTHON) derivations/clustering.py

smoke:
	$(PYTHON) chip_smoke.py

clean:
	rm -rf build .pytest_cache
	find . -name __pycache__ -type d | xargs rm -rf

.PHONY: all ext proto test test-fast bench bench-suite demo derivations \
	smoke clean
