from repro_torch.data.synthetic import Dataset, brute_force_topk, \
    make_dataset, make_embeddings, make_token_batch, split_tokens

__all__ = ["Dataset", "brute_force_topk", "make_dataset", "make_embeddings",
           "make_token_batch", "split_tokens"]
