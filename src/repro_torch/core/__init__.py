"""repro_torch.core"""
