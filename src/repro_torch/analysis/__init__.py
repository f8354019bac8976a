"""repro_torch.analysis"""
