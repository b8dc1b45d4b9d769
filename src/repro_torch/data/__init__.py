from .pipeline import SyntheticLMDataset, make_batch_iterator
