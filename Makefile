# Convenience targets (role parity with the reference's Makefile build +
# smoke-test targets, /root/reference/Makefile:51-62).  The package needs
# no build step; `native` prebuilds the C++ I/O fast path.

PYTHON ?= python
OUT ?= test_output
SEED ?= 1
READS ?= 2500

.PHONY: all native test inputs test_se test_pe test_pei bench smoke clean

all: native

native:
	$(PYTHON) -c "from sickle_tpu.io import native; assert native.available(), 'g++ build failed'; print('native io ready:', native._SO)"

test:
	$(PYTHON) -m pytest tests/ -q

$(OUT):
	mkdir -p $(OUT)

# seeded inputs (sickle_tpu/tools/synth_fastq.py): se, mates, interleaved
inputs: | $(OUT)
	$(PYTHON) -m sickle_tpu.tools.synth_fastq -n $(READS) --seed $(SEED) \
	  -o $(OUT)/test.fastq
	$(PYTHON) -m sickle_tpu.tools.synth_fastq -n $(READS) --seed $(SEED) \
	  -o $(OUT)/test.f.fastq -p $(OUT)/test.r.fastq
	$(PYTHON) -m sickle_tpu.tools.synth_fastq -n $(READS) --seed $(SEED) \
	  -c $(OUT)/test.pei.fastq

test_se: inputs
	$(PYTHON) -m sickle_tpu se -f $(OUT)/test.fastq -t sanger -q 20 \
	  -o $(OUT)/test.fastq.se.out > $(OUT)/test.se.txt
	cat $(OUT)/test.se.txt

test_pe: inputs
	$(PYTHON) -m sickle_tpu pe -t sanger -q 20 \
	  -f $(OUT)/test.f.fastq -r $(OUT)/test.r.fastq \
	  -o $(OUT)/test.fastq.pe1.out -p $(OUT)/test.fastq.pe2.out \
	  -s $(OUT)/test.fastq.pes.out > $(OUT)/test.pe.txt
	cat $(OUT)/test.pe.txt

test_pei: inputs
	$(PYTHON) -m sickle_tpu pe -t sanger -q 20 \
	  -c $(OUT)/test.pei.fastq -M $(OUT)/test.fastq.pei.out \
	  > $(OUT)/test.pei.txt
	cat $(OUT)/test.pei.txt

bench:
	$(PYTHON) bench.py

# on a GPU host: kernels + CLI end to end, checked exactly
smoke:
	$(PYTHON) chip_smoke.py

clean:
	rm -rf $(OUT) sickle_tpu/io/_build
