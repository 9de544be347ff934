"""Device ms of PyTorch's elementwise, reduction, concatenation and
indexing kernels per candidate-epoch of the profiled rho searches."""
from portbench import readers

KERNELS = ('elementwise_kernel', 'reduce_kernel', 'CatArrayBatchedCopy',
           'index_select', 'indexSelect', 'compute_cuda_kernel',
           'tensor_kernel_scan')


def read(ctx):
    return readers.kernel_ms_per(ctx, KERNELS, 'cand_epochs')
