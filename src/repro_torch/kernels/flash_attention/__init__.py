"""Flash attention forward: online softmax, causal and sliding window, GQA."""
