// How many clusters of C CTAs shaped like the return-hidden backward (256
// threads, a floor of 3 CTAs an SM, about 77 KB of shared memory, or less)
// one CUDA card holds at once, for C = 1, 2, 4, 8: cudaOccupancyMaxActiveClusters
// and cudaOccupancyMaxActiveBlocksPerMultiprocessor. A grid of more clusters
// runs in more than one wave. Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/cluster_occupancy tools/cluster_occupancy.cu && build/cluster_occupancy
#include <cstdio>
#include <cuda_runtime.h>
template <int C>
__global__ void __cluster_dims__(C, 1, 1) __launch_bounds__(256, 3) k(float* p) {
  extern __shared__ float s[];
  s[threadIdx.x] = threadIdx.x;
  __syncthreads();
  if (p) p[blockIdx.x] = s[255 - threadIdx.x];
}
template <int C>
void probe(size_t smem) {
  cudaFuncSetAttribute(k<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(k<C>, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(384, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C; attr.val.clusterDim.y = 1; attr.val.clusterDim.z = 1;
  cfg.attrs = &attr; cfg.numAttrs = 1;
  int clusters = -1, blocks = -1;
  cudaError_t e1 = cudaOccupancyMaxActiveClusters(&clusters, k<C>, &cfg);
  cudaError_t e2 = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k<C>, 256, smem);
  printf("cluster %d smem %zu: max active clusters %d (CTAs %d), blocks/SM %d  [%d %d]\n", C, smem,
         clusters, clusters * C, blocks, (int)e1, (int)e2);
}
int main() {
  for (size_t smem : {76608ul, 70000ul, 60000ul, 45000ul}) {
    probe<1>(smem); probe<2>(smem); probe<4>(smem); probe<8>(smem);
  }
  cudaDeviceProp pr; cudaGetDeviceProperties(&pr, 0);
  printf("SMs %d, smem/SM %zu, smem/block optin %zu, reserved/block %zu\n", pr.multiProcessorCount,
         pr.sharedMemPerMultiprocessor, pr.sharedMemPerBlockOptin, pr.reservedSharedMemPerBlock);
  return 0;
}
