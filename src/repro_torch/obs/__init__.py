"""repro_torch.obs"""
