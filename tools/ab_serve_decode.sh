#!/bin/bash
# Same-call A/B of the llama3-8b serve path on one CUDA card: the parent
# checkout's launcher and this tree's, in turns (parent, tree, tree,
# parent, parent, tree), each in its own process with its own kernel build.
#
#   mkdir -p build/ab_parent && git archive <commit> src | tar -x -C build/ab_parent
#   bash tools/ab_serve_decode.sh
#
# Each run prints the launcher's prefill ms and decode ms a token (batch 4,
# a 2048-token prompt, 32 greedy tokens, random bf16 weights).
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for side in parent tree tree parent parent tree; do
  if [ "$side" = parent ]; then src=build/ab_parent/src; else src=src; fi
  echo "== $side"
  PYTHONPATH=$src python3 -m repro_torch.launch.serve --batch 4 \
    --prompt-len 2048 --max-new 32 2>&1 | grep -v "^  seq"
done
