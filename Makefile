# Build/test targets — parity with the reference's Makefile (clippy/test/
# benchmarks, /root/reference/Makefile:1-10) and CI (.github/workflows/ci.yml).

.PHONY: lint test test-slow test-all bench native clean

lint:
	python scripts/lint.py

# fast tier (excludes slow/gpu-marked tests) — the CI gate
test: lint
	python -m pytest tests/ -x -q -m "not slow and not gpu"

test-slow:
	python -m pytest tests/ -x -q -m "slow and not gpu"

test-all:
	python -m pytest tests/ -x -q

bench:
	python bench.py

native:
	python -c "from aes_zero_knowledge_proof_circuit_tpu import native; \
	  assert native.available(), 'native build failed'; print('native OK')"

clean:
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null; true
